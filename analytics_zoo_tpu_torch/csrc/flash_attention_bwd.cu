// Flash attention backward for NVIDIA Hopper (sm_90a): two kernels on the
// tensor cores.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py::_bwd_dq_kernel (:158)
// and ::_bwd_dkv_kernel (:194), the Pallas TPU kernels that _flash_bwd
// (:240) hands to pl.pallas_call (:272, :290).  With s = q·kᵀ·scale,
// p = exp(s − lse) (the forward's per-row log-sum-exp, so p is the softmax
// recomputed without a second reduction), the causal mask key ≤ query, and
// the per-row δ = rowsum(dO·O) − g_lse computed by the caller:
//   ds = p·(dO·vᵀ − δ)
//   dq = ds·k·scale              (flash_bwd_dq_kernel)
//   dk = dsᵀ·q·scale, dv = pᵀ·dO  (flash_bwd_dkv_kernel)
// q/k/v/dO are f32 or bf16; dq/dk/dv are written in the input dtype.
//
// What bounds it on the card: operations.  At the training path's shape
// (B·H = 96, T = 1024, D = 64, causal) the function needs 10·D flop per
// kept (query, key) pair (recompute s, then dp, dv, dk, dq), 32.2 GFLOP,
// against ~0.2 GB of q, k, v, O, dO, dq, dk and dv.  An f32-accurate
// product on the tensor cores costs three TF32 products, so the bound is
// 32.2 GFLOP at a third of the dense TF32 rate (495 / 3 = 165 TFLOP/s),
// about 0.195 ms.  Both kernels recompute s and dp (14·D flop a pair), so
// they can reach at most ~71% of it.  The design:
//  - every product (s, dp, dq in one kernel; sᵀ, dpᵀ, dv, dk in the other)
//    is mma.sync.m16n8k8 with TF32 operands in 3xTF32: each f32 operand x
//    is split into big = rna(x) and small = rna(x − big), rna being
//    cvt.rna.tf32.f32, and big·small + small·big is accumulated before
//    big·big.  One TF32 product alone would be ~1e-3 off.  The tensor core
//    truncates each mma's sum to 24 bits, so a running sum must not be its
//    C operand: products over the head dimension sum two k-steps (6 mmas)
//    into a zeroed partial, products over tokens one k-step (3 mmas), and
//    an f32 add puts the partial into the sum.  A widened bf16 value is
//    exact in TF32, so for bf16 inputs its small part is zero and those
//    products are skipped; p and ds are f32 and keep their split.  mma.sync
//    rather than wgmma: wgmma takes TF32 operands only K-major, and
//    dq = ds·k, dk = dsᵀ·q and dv = pᵀ·dO contract over tokens.
//  - four warps a block, each owning 16 rows: dq has queries as rows (64
//    a block) and walks 32-key tiles; dk/dv has keys as rows (64 a block,
//    it computes sᵀ = k·qᵀ) and walks 32-query tiles.  A warp's s and dp
//    are m16n8 accumulators in registers, p and ds are formed there, and
//    they feed the second product as its A operand with no move at all:
//    the contraction of that product takes the accumulator's columns 2t
//    and 2t + 1 as its slots t and t + 4, and reads its B operand from
//    shared memory in the same order.
//  - every operand is split once, when its tile arrives in shared memory,
//    into (big, small) pairs, so no warp splits what another has split: a
//    block's own 64 rows (q and dO in dq; k and v in dk/dv) in the A
//    layout, each lane's fragment one 16-byte load per part; the streamed
//    tiles in the row layout, a 16-byte chunk holding two neighbouring
//    elements' parts.
//  - the streamed tiles (k and v in dq; q, dO, lse and δ in dk/dv) have
//    two shared-memory stages: the next tile's raw cp.async copies (16
//    bytes a copy for f32, 8 for bf16) are issued into the raw stage before
//    the current tile's products, which read the split stage; then
//    cp.async.wait_group, __syncthreads() and the split.  Rows at or past T
//    are zero-filled by cp.async's src-size operand (0 bytes read), so no
//    padded copies are made in HBM; padded query rows get p = 0, keys at or
//    past T are masked in dq and their dk/dv rows are never written.
//  - the row layout stores chunk c of row r at c ^ sw(r), sw(r) =
//    (r & 1)·4 + (r >> 1 & 3): the 16-byte loads of both products, along d
//    (rows g, chunks 4m + t) and along tokens (rows 2t and 2t + 1, chunks
//    g·D/16 + i), hit eight distinct bank quads a quarter-warp at D = 64
//    (two-way at 32 and 128 along tokens).  The A layout is contiguous.
//  - exp is ex2.approx of an FMA in the log2 domain, and tiles the mask
//    keeps whole skip it.
//  - two kernels, as the TPU package has, so every gradient element is
//    written by exactly one block: no atomics, and two backward calls give
//    bitwise-equal gradients.  Under the causal mask dq stops at the
//    diagonal key tile and dk/dv starts at the diagonal query tile; the
//    heavy tiles are issued first.
//  - every tensor is read through its (b, h, t) strides: q/k/v are views
//    of the fused qkv projection and dO arrives from autograd as a strided
//    view; dq/dk/dv are written through theirs, in (B, T, H, D) memory.
//  Shared memory, at D = 64 f32: 112 KiB a block (two blocks an SM).
//  The split, the mma helpers, the copies, the layouts and the fragment
//  loaders are in mma_tf32.cuh, shared with the forward and fused_bn.
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

#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // a block's own rows: queries (dq), keys (dk/dv)
constexpr int kStream = 32;          // rows of each streamed tile

// Copy n floats of a contiguous (B, H, T) row vector from t0 (zeros past T).
__device__ __forceinline__ void load_vec(float* dst, const float* src, int t0,
                                         int T, int n) {
  const int i = threadIdx.x;
  if (i < n) cp_async<4>(dst + i, src + (t0 + i < T ? t0 + i : 0), t0 + i < T);
}

// dq: p = exp(s·scale − lse) and ds = p·(dp − δ) in place of dp, rows are
// queries (q_g: this lane's row g, lse2 = lse·log2 e), columns keys (k_t:
// this lane's column 2t); MASK applies the causal mask and keys past T
template <int NJ, bool MASK>
__device__ __forceinline__ void ds_rows(const float (&s)[NJ][4],
                                        float (&dp)[NJ][4],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], float sl,
                                        int q_g, int k_t, int T, int causal) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = exp2_approx(fmaf(s[j][e], sl, -lse2[i]));
      if constexpr (MASK) {
        const int kpos = k_t + 8 * j + (e & 1);
        if (kpos >= T || (causal && kpos > q_g + 8 * i)) p = 0.f;
      }
      dp[j][e] = p * (dp[j][e] - dl[i]);
    }
}

// dk/dv: the same with keys as rows (k_g) and queries as columns (q_t),
// lse and δ of the query tile in shared memory; p replaces s
template <int NJ, bool MASK>
__device__ __forceinline__ void ds_cols(float (&s)[NJ][4], float (&dp)[NJ][4],
                                        const float* L, const float* Dl,
                                        float sl, int k_g, int q_t, int t,
                                        int T, int causal) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 lq = *reinterpret_cast<const float2*>(L + 8 * j + 2 * t);
    const float2 dq = *reinterpret_cast<const float2*>(Dl + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = (e & 1) ? lq.y : lq.x;
      float p = exp2_approx(fmaf(s[j][e], sl, -l * kLog2e));
      if constexpr (MASK) {
        const int qpos = q_t + 8 * j + (e & 1);
        if (qpos >= T || (causal && k_g + 8 * (e >> 1) > qpos)) p = 0.f;
      }
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - ((e & 1) ? dq.y : dq.x));
    }
  }
}

// raw staging: the larger of a block's own rows in either input type
template <typename TI, typename TG, int D>
__host__ __device__ constexpr int raw_bytes() {
  return kRows * D * (int)(sizeof(TI) > sizeof(TG) ? sizeof(TI) : sizeof(TG));
}

template <typename TI, typename TG, int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 4 * 2 * D * 2 * (kRows + kStream) + raw_bytes<TI, TG, D>();
}

template <typename TI, typename TG, int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 4 * 2 * D * 2 * (kRows + kStream) + raw_bytes<TI, TG, D>() +
         4 * 2 * 2 * kStream;
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
  constexpr int BQ = kRows, BK = kStream, NJ = BK / 8, NT = D / 8;
  constexpr bool XI = Elt<TI>::exact, XG = Elt<TG>::exact;
  extern __shared__ uint4 smem4[];
  uint32_t* Qs = reinterpret_cast<uint32_t*>(smem4);   // split, A layout
  uint32_t* Gs = Qs + BQ * 2 * D;                      // dO
  // Ks, Vs: split, row layout
  uint32_t* Ks = Gs + BQ * 2 * D;
  uint32_t* Vs = Ks + BK * 2 * D;
  void* raw = Vs + BK * 2 * D;                         // cp.async staging
  TI* rk = reinterpret_cast<TI*>(raw);
  TI* rv = rk + BK * D;

  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;   // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * BQ;
  const int r0 = 16 * (threadIdx.x >> 5);   // the warp's rows in the tile
  const Lane<D> L;
  const int afrag = (r0 >> 4) * (D / 8) * 256 + (threadIdx.x & 31) * 4;
  const TI* kp = k + b * skb + h * skh;
  const TI* vp = v + b * svb + h * svh;

  // q and dO stay for the whole loop: staged raw and split once
  load_raw<kThreads, TI, D, BQ>(reinterpret_cast<TI*>(raw), q + b * sqb + h * sqh, sqt, q0, T);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  split_frags<kThreads, TI, D, BQ>(Qs, reinterpret_cast<const TI*>(raw));
  __syncthreads();
  load_raw<kThreads, TG, D, BQ>(reinterpret_cast<TG*>(raw), dout + b * sgb + h * sgh, sgt, q0, T);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  split_frags<kThreads, TG, D, BQ>(Gs, reinterpret_cast<const TG*>(raw));
  __syncthreads();
  load_raw<kThreads, TI, D, BK>(rk, kp, skt, 0, T);
  load_raw<kThreads, TI, D, BK>(rv, vp, svt, 0, T);
  cp_commit();

  float lr[2], dr[2];   // lse·log2 e and δ of rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = q0 + r0 + L.g + 8 * i;
    lr[i] = tq < T ? lse[(long long)bh * T + tq] * kLog2e : 0.f;
    dr[i] = tq < T ? delta[(long long)bh * T + tq] : 0.f;
  }
  const float sl = scale * kLog2e;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait_all();
    __syncthreads();   // tile kt has landed; the last tile's readers are done
    split_rows<kThreads, TI, D, BK>(Ks, rk);
    split_rows<kThreads, TI, D, BK>(Vs, rv);
    __syncthreads();
    if (kt + 1 < n_kt) {   // the next tile flies while this one is used
      load_raw<kThreads, TI, D, BK>(rk, kp, skt, (kt + 1) * BK, T);
      load_raw<kThreads, TI, D, BK>(rv, vp, svt, (kt + 1) * BK, T);
    }
    cp_commit();

    float s[NJ][4], dp[NJ][4];
    product_over_d<D, NJ, XI, XI>(s, Qs + afrag, Ks + L.g * 2 * D, L);   // q·kᵀ
    product_over_d<D, NJ, XG, XI>(dp, Gs + afrag, Vs + L.g * 2 * D, L);  // dO·vᵀ

    const int k0 = kt * BK;
    const int q_g = q0 + r0 + L.g, k_t = k0 + 2 * L.t;
    if (k0 + BK <= T && (!causal || k0 + BK - 1 <= q0 + r0))
      ds_rows<NJ, false>(s, dp, lr, dr, sl, q_g, k_t, T, causal);
    else
      ds_rows<NJ, true>(s, dp, lr, dr, sl, q_g, k_t, T, causal);

#pragma unroll
    for (int j = 0; j < NJ; ++j) {   // dq += ds·k
      uint32_t ab[4], as[4];
      frag_acc(dp[j], ab, as);
      product_over_tokens<D, XI>(acc, ab, as, Ks + j * 16 * D, L);
    }
  }
  store_rows<TI, D>(dq + b * sdb + h * sdh, sdt, q0 + r0, T, acc, scale);
}

template <typename TI, typename TG, int D>
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
  constexpr int BK = kRows, BQ = kStream, NJ = BQ / 8, NT = D / 8;
  constexpr bool XI = Elt<TI>::exact, XG = Elt<TG>::exact;
  extern __shared__ uint4 smem4[];
  uint32_t* Ks = reinterpret_cast<uint32_t*>(smem4);   // split, A layout
  uint32_t* Vs = Ks + BK * 2 * D;
  // Qs, Gs (dO): split, row layout
  uint32_t* Qs = Vs + BK * 2 * D;
  uint32_t* Gs = Qs + BQ * 2 * D;                      // dO
  char* raw = reinterpret_cast<char*>(Gs + BQ * 2 * D);   // cp.async staging
  TI* rq = reinterpret_cast<TI*>(raw);
  TG* rg = reinterpret_cast<TG*>(raw + BQ * D * sizeof(TI));
  float* Ls = reinterpret_cast<float*>(raw + raw_bytes<TI, TG, D>());   // 2 x BQ
  float* Dl = Ls + 2 * BQ;                                              // 2 x BQ, δ

  const int kt = blockIdx.x;     // low key tiles carry the most causal work
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = kt * BK;
  const int r0 = 16 * (threadIdx.x >> 5);   // the warp's keys in the tile
  const Lane<D> L;
  const int afrag = (r0 >> 4) * (D / 8) * 256 + (threadIdx.x & 31) * 4;
  const float sl = scale * kLog2e;
  const TI* qp = q + b * sqb + h * sqh;
  const TG* gp = dout + b * sgb + h * sgh;
  const float* lp = lse + (long long)bh * T;
  const float* dlp = delta + (long long)bh * T;
  const int n_qt = (T + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;

  // k and v stay for the whole loop: staged raw and split once
  load_raw<kThreads, TI, D, BK>(reinterpret_cast<TI*>(raw), k + b * skb + h * skh, skt, k0, T);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  split_frags<kThreads, TI, D, BK>(Ks, reinterpret_cast<const TI*>(raw));
  __syncthreads();
  load_raw<kThreads, TI, D, BK>(reinterpret_cast<TI*>(raw), v + b * svb + h * svh, svt, k0, T);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  split_frags<kThreads, TI, D, BK>(Vs, reinterpret_cast<const TI*>(raw));
  __syncthreads();
  load_raw<kThreads, TI, D, BQ>(rq, qp, sqt, qt0 * BQ, T);
  load_raw<kThreads, TG, D, BQ>(rg, gp, sgt, qt0 * BQ, T);
  load_vec(Ls, lp, qt0 * BQ, T, BQ);
  load_vec(Dl, dlp, qt0 * BQ, T, BQ);
  cp_commit();

  float ak[NT][4], av[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int stage = (qt - qt0) & 1;
    cp_wait_all();
    __syncthreads();   // tile qt has landed; the last tile's readers are done
    split_rows<kThreads, TI, D, BQ>(Qs, rq);
    split_rows<kThreads, TG, D, BQ>(Gs, rg);
    __syncthreads();
    if (qt + 1 < n_qt) {   // the next tile flies while this one is used
      const int nq = (qt + 1) * BQ;
      load_raw<kThreads, TI, D, BQ>(rq, qp, sqt, nq, T);
      load_raw<kThreads, TG, D, BQ>(rg, gp, sgt, nq, T);
      load_vec(Ls + (stage ^ 1) * BQ, lp, nq, T, BQ);
      load_vec(Dl + (stage ^ 1) * BQ, dlp, nq, T, BQ);
    }
    cp_commit();
    const float* Lt = Ls + stage * BQ;
    const float* Dt = Dl + stage * BQ;

    // scores transposed: rows are this block's keys, columns the queries
    float s[NJ][4], dp[NJ][4];
    product_over_d<D, NJ, XI, XI>(s, Ks + afrag, Qs + L.g * 2 * D, L);   // k·qᵀ
    product_over_d<D, NJ, XI, XG>(dp, Vs + afrag, Gs + L.g * 2 * D, L);  // v·dOᵀ

    const int q0 = qt * BQ;
    const int k_g = k0 + r0 + L.g, q_t = q0 + 2 * L.t;
    if (q0 + BQ <= T && (!causal || k0 + r0 + 15 <= q0))
      ds_cols<NJ, false>(s, dp, Lt, Dt, sl, k_g, q_t, L.t, T, causal);
    else
      ds_cols<NJ, true>(s, dp, Lt, Dt, sl, k_g, q_t, L.t, T, causal);

#pragma unroll
    for (int j = 0; j < NJ; ++j) {   // dv += pᵀ·dO, dk += dsᵀ·q
      uint32_t ab[4], as[4];
      frag_acc(s[j], ab, as);
      product_over_tokens<D, XG>(av, ab, as, Gs + j * 16 * D, L);
      frag_acc(dp[j], ab, as);
      product_over_tokens<D, XI>(ak, ab, as, Qs + j * 16 * D, L);
    }
  }
  store_rows<TI, D>(dk + b * skob + h * skoh, skot, k0 + r0, T, ak, scale);
  store_rows<TI, D>(dv + b * svob + h * svoh, svot, k0 + r0, T, av, 1.f);
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
  auto kern = flash_bwd_dq_kernel<TI, TG, D>;
  constexpr int smem = dq_smem_bytes<TI, TG, D>();
  static bool configured = false;
  if (const int e = allow_smem(kern, smem, configured)) return e;
  const dim3 grid((T + kRows - 1) / kRows, B * H);
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
  auto kern = flash_bwd_dkv_kernel<TI, TG, D>;
  constexpr int smem = dkv_smem_bytes<TI, TG, D>();
  static bool configured = false;
  if (const int e = allow_smem(kern, smem, configured)) return e;
  const dim3 grid((T + kRows - 1) / kRows, B * H);
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

// Dynamic shared memory of one block of the dq (dkv = 0) or dk/dv (dkv = 1)
// kernel, in bytes; 0 for a head_dim the kernels do not take.
extern "C" int flash_attention_bwd_smem(int in_bf16, int g_bf16, int D,
                                        int dkv) {
  using bf = __nv_bfloat16;
  const int i = (D == 32 ? 0 : D == 64 ? 1 : D == 128 ? 2 : -1);
  if (i < 0) return 0;
  const int sizes[2][3][3] = {
      {{dq_smem_bytes<float, float, 32>(), dq_smem_bytes<float, float, 64>(),
        dq_smem_bytes<float, float, 128>()},
       {dq_smem_bytes<bf, bf, 32>(), dq_smem_bytes<bf, bf, 64>(),
        dq_smem_bytes<bf, bf, 128>()},
       {dq_smem_bytes<bf, float, 32>(), dq_smem_bytes<bf, float, 64>(),
        dq_smem_bytes<bf, float, 128>()}},
      {{dkv_smem_bytes<float, float, 32>(), dkv_smem_bytes<float, float, 64>(),
        dkv_smem_bytes<float, float, 128>()},
       {dkv_smem_bytes<bf, bf, 32>(), dkv_smem_bytes<bf, bf, 64>(),
        dkv_smem_bytes<bf, bf, 128>()},
       {dkv_smem_bytes<bf, float, 32>(), dkv_smem_bytes<bf, float, 64>(),
        dkv_smem_bytes<bf, float, 128>()}}};
  return sizes[dkv ? 1 : 0][!in_bf16 ? 0 : g_bf16 ? 1 : 2][i];
}

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
