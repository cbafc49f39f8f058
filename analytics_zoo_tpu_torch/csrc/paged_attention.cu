// Paged decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces analytics_zoo_tpu/ops/paged_attention.py::_paged_kernel, the
// Pallas TPU kernel that _paged_pallas hands to pl.pallas_call: one query
// token per row attends over the row's KV cache, which lives in a block
// pool (n_blocks, block_len, heads, head_dim) and is addressed through the
// row's block table.  Positions at or past the row's length are masked.
// int8 pools carry one f32 scale per (block, head).
//
// What bounds it on the card: device-memory bytes, and at decode-time
// lengths the latency of the loads that fetch them.  Each (row, head) pair
// reads len * head_dim keys and as many values (4 bytes an element for f32
// pools, 1 for int8) and does about 4 flops per element it reads, far below
// the ~20 flops a byte at which an H100 stops being limited by its 3.35
// TB/s.  A decode step has few rows, so what limits a call is how few
// dependent round trips to device memory each block makes and how many
// bytes each SM keeps in flight.  The design:
//  - one round trip before K/V: a block loads its row's length, the table
//    entries of its partition (into shared memory, one coalesced load) and
//    its query together; each K/V load then issues with its (block, head)
//    scale.  The TPU kernel gets the table by scalar prefetch.
//  - the walk over a row's positions is split into partitions of
//    per_part table entries (flash-decoding): partition p of (row, head)
//    is block p of a thread-block cluster of `parts` blocks.  Each block
//    merges its warps' (max, sum, accumulator) and, with parts > 1, block 0
//    of the cluster merges the partitions' partials through distributed
//    shared memory: no scratch in device memory, no second launch.  The
//    wrapper's rule (ops/paged_attention.partitions) picks one partition
//    for tables of up to 16 entries, so the decode path's calls are one
//    plain launch, and up to 8 (a portable cluster) for long caches.  A
//    partition with no valid position contributes nothing.
//  - inside a block, the partition's valid positions are cut into chunks
//    of CHUNK consecutive positions, which may cross table entries; warp w
//    takes chunks w, w + kWarps, ...  Only positions below the length are
//    read: the TPU kernel walks every entry and masks, and masked
//    positions add exactly zero, so skipping them changes nothing but the
//    bytes moved.
//  - a lane loads 16 bytes of a position's head vector at a time (4 f32
//    elements, or 16 int8 ones, dequantized in registers), so a warp-wide
//    load moves 512 bytes of either pool; head_dim / VEC lanes share a
//    position.  A warp issues its next chunk's K/V loads before it uses the
//    current chunk, so two chunks a warp are in flight.
//  - scores are reduced across the lanes of a position with shuffles; the
//    online softmax (running max, sum, accumulator) lives in registers.
//
// C interface, loaded with ctypes (analytics_zoo_tpu_torch/ops/_build.py):
// each entry point launches on the given stream, allocates nothing, and
// returns the CUDA error of the launch (0 = launched).  head_dim must be 4,
// 8, 16, 32, 64 or 128; q must be 16-byte aligned, the pools aligned to
// min(16, head_dim * element size) bytes.  1 <= parts <= 8 partitions of
// per_part entries must cover the table: (parts - 1) * per_part < n_table
// <= parts * per_part.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxParts = 8;       // a portable cluster
constexpr int kTabCap = 2048;      // table entries a block keeps in shared memory
constexpr unsigned kFull = 0xffffffffu;

// How a lane reads a pool: VEC head_dim elements (16 bytes where the head
// vector allows), NW 32-bit words; U loads of K (and of V) a chunk.
template <typename T, int HD>
struct Lanes;
template <int HD>
struct Lanes<float, HD> {
  static constexpr int VEC = 4;
  static constexpr int NW = 4;
  static constexpr int U = 4;
};
template <int HD>
struct Lanes<int8_t, HD> {
  static constexpr int VEC = HD < 16 ? HD : 16;
  static constexpr int NW = VEC / 4;
  static constexpr int U = 3;   // 24 positions at head_dim 64: a decode
                                // row of up to 192 is one chunk a warp
};

template <int NW>
__device__ __forceinline__ void ldg_words(const void* p, uint32_t (&w)[NW]) {
  if constexpr (NW == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (NW == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// the VEC elements of a lane's words as f32.  int8: the byte with its
// sign bit flipped (b + 128) put into the mantissa of 2^23 by one PRMT,
// less 2^23 + 128, which is exact: two instructions an element where a
// sign extension and an I2F (a quarter-rate conversion) take three
template <typename T, int VEC, int NW>
__device__ __forceinline__ void unpack(const uint32_t (&w)[NW], float (&f)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if constexpr (sizeof(T) == 4)
      f[e] = __uint_as_float(w[e]);
    else
      f[e] = __uint_as_float(__byte_perm(w[e >> 2] ^ 0x80808080u,
                                         0x4B000000u, (e & 3) | 0x7650))
             - 8388736.f;
  }
}

// grid rows * heads * parts, block kThreads, clusters of (parts, 1, 1);
// dynamic shared memory: min(per_part, kTabCap) table entries.  k_scale /
// v_scale are null for f32 pools.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       float* __restrict__ out,
                       int nh, int bl, int n_table, int parts, int per_part,
                       float scale) {
  using L = Lanes<T, HD>;
  constexpr int VEC = L::VEC, NW = L::NW, U = L::U;
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int LANES = HD / VEC;          // lanes a position
  constexpr int PPW = 32 / LANES;          // positions a warp-wide load
  constexpr int CHUNK = PPW * U;           // positions a chunk
  extern __shared__ int s_tab[];
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][HD];
  __shared__ float s_part[HD + 2];         // numerator, max, denominator

  // blocks of one row are adjacent, its heads' partitions in turn: a
  // position's K (and V) of every head, one contiguous run, is read by
  // blocks that run at the same time
  const int rh = blockIdx.x / parts;
  const int part = blockIdx.x - rh * parts;
  const int a = rh / nh;
  const int h = rh - a * nh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LANES;            // which position of a load
  const int dl = lane % LANES;             // which VEC elements of head_dim

  // The one round trip before K/V: length, table entries and q together.
  const int e0 = part * per_part;
  const int n_e = min(per_part, n_table - e0);
  const int* trow = tables + (size_t)a * n_table + e0;
  int len = __ldg(lengths + a);
  for (int i = threadIdx.x; i < min(n_e, kTabCap); i += kThreads)
    s_tab[i] = __ldg(trow + i);
  const size_t row_head = (size_t)a * nh + h;
  float qv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; e += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        q + row_head * HD + dl * VEC + e));
    qv[e] = v.x; qv[e + 1] = v.y; qv[e + 2] = v.z; qv[e + 3] = v.w;
  }
  __syncthreads();

  // len <= 0 masks every position, and the reference softmax over scores
  // that are all -1e30 is uniform over the whole table: every position
  // then counts, with equal scores.  len past the table clamps to it.
  const int cap = n_table * bl;
  const bool uniform = len <= 0;
  if (uniform || len > cap) len = cap;
  const int p0 = e0 * bl;                          // this partition's
  const int p1 = min(len, (e0 + n_e) * bl);        // positions [p0, p1)

  const size_t pos_stride = (size_t)nh * HD;       // between positions
  const T* kb = k_pool + (size_t)h * HD + dl * VEC;
  const T* vb = v_pool + (size_t)h * HD + dl * VEC;

  struct Chunk {
    uint32_t k[U][NW];
    uint32_t v[U][NW];
    float ks[QUANT ? U : 1];
    float vs[QUANT ? U : 1];
  };
  // a chunk's loads: position j of the walk is entry j / bl, slot j % bl
  auto issue = [&](int pc, Chunk& c) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = pc + u * PPW + sub;
      if (j < p1) {
        const int t = j / bl;
        const int e = t - e0;
        const int blk = e < kTabCap ? s_tab[e] : __ldg(trow + e);
        const size_t off = ((size_t)blk * bl + (j - t * bl)) * pos_stride;
        ldg_words<NW>(kb + off, c.k[u]);
        ldg_words<NW>(vb + off, c.v[u]);
        if constexpr (QUANT) {
          c.ks[u] = __ldg(k_scale + (size_t)blk * nh + h);
          c.vs[u] = __ldg(v_scale + (size_t)blk * nh + h);
        }
      } else {
#pragma unroll
        for (int w = 0; w < NW; ++w) c.k[u][w] = c.v[u][w] = 0u;
        if constexpr (QUANT) c.ks[u] = c.vs[u] = 0.f;
      }
    }
  };

  float m = -INFINITY;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // the online softmax over one chunk (its first position is valid)
  auto consume = [&](int pc, const Chunk& c) {
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      unpack<T, VEC, NW>(c.k[u], kf);
      s[u] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[u] += qv[e] * kf[e];
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(kFull, s[u], o);
    }
    float cmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = pc + u * PPW + sub;
      float ks = 1.f;
      if constexpr (QUANT) ks = c.ks[u];
      s[u] = j < p1 ? (uniform ? 0.f : s[u] * ks * scale) : -INFINITY;
      cmax = fmaxf(cmax, s[u]);
    }
#pragma unroll
    for (int o = LANES; o < 32; o <<= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, o));
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(s[u] - m_new);   // 0 at masked positions
      float vs = 1.f;
      if constexpr (QUANT) vs = c.vs[u];
      float vf[VEC];
      unpack<T, VEC, NW>(c.v[u], vf);
      psum += p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += p * (vf[e] * vs);
    }
#pragma unroll
    for (int o = LANES; o < 32; o <<= 1)
      psum += __shfl_xor_sync(kFull, psum, o);
    l = l * alpha + psum;
    m = m_new;
  };

  // two chunks in flight: the next one's loads go out before this one is used
  int pc = p0 + warp * CHUNK;
  Chunk cur, nxt;
  if (pc < p1) issue(pc, cur);
  while (pc < p1) {
    const int pn = pc + kWarps * CHUNK;
    if (pn < p1) issue(pn, nxt);
    consume(pc, cur);
    cur = nxt;
    pc = pn;
  }

  // fold the warp's position groups (same max, same elements), then the
  // warps through shared memory
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] += __shfl_xor_sync(kFull, acc[e], o);
  }
  if (lane < LANES) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_acc[warp][dl * VEC + e] = acc[e];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();
  // a warp that walked no chunk holds (-inf, 0, 0) and counts for nothing
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w]);
  float c_w[kWarps];
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    c_w[w] = s_m[w] == -INFINITY ? 0.f : expf(s_m[w] - mx);
    den += s_l[w] * c_w[w];
  }
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) num += s_acc[w][d] * c_w[w];
    if (parts == 1)
      out[row_head * HD + d] = num / den;
    else
      s_part[d] = num;
  }
  if (parts == 1) return;

  // partitions: block 0 of the cluster reads every block's partial from
  // its shared memory; a partition with no valid position has max -inf
  if (threadIdx.x == 0) {
    s_part[HD] = mx;
    s_part[HD + 1] = den;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (part == 0) {
    for (int d = threadIdx.x; d < HD; d += kThreads) {
      float gm = -INFINITY;
      for (int r = 0; r < parts; ++r)
        gm = fmaxf(gm, cluster.map_shared_rank(s_part, r)[HD]);
      float num = 0.f;
      float dsum = 0.f;
      for (int r = 0; r < parts; ++r) {
        const float* pr = cluster.map_shared_rank(s_part, r);
        const float c = pr[HD] == -INFINITY ? 0.f : expf(pr[HD] - gm);
        num += pr[d] * c;
        dsum += pr[HD + 1] * c;
      }
      out[row_head * HD + d] = num / dsum;
    }
  }
  // the other blocks' shared memory must outlive block 0's reads
  cluster.sync();
}

template <typename T, int HD>
cudaError_t launch_hd(const float* q, const T* k_pool, const T* v_pool,
                      const float* k_scale, const float* v_scale,
                      const int* tables, const int* lengths, float* out,
                      int rows, int nh, int bl, int n_table, int parts,
                      int per_part, float scale, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * nh * parts), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(int) * (size_t)min(per_part, kTabCap);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = parts > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, paged_attention_kernel<T, HD>, q, k_pool,
                            v_pool, k_scale, v_scale, tables, lengths, out,
                            nh, bl, n_table, parts, per_part, scale);
}

template <typename T>
int launch(const float* q, const T* k_pool, const T* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* lengths, float* out, int rows, int nh, int hd, int bl,
           int n_table, int parts, int per_part, float scale, void* stream) {
  if (rows < 0 || nh < 1 || bl < 1 || n_table < 1
      || parts < 1 || parts > kMaxParts || per_part < 1
      || (long long)(parts - 1) * per_part >= n_table
      || (long long)parts * per_part < n_table
      || (long long)n_table * bl > 0x7fffffffLL
      || (long long)rows * nh * parts > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define AZ_PAGED_LAUNCH(HD)                                                  \
  err = launch_hd<T, HD>(q, k_pool, v_pool, k_scale, v_scale, tables,       \
                         lengths, out, rows, nh, bl, n_table, parts,        \
                         per_part, scale, s)
  switch (hd) {
    case 4: AZ_PAGED_LAUNCH(4); break;
    case 8: AZ_PAGED_LAUNCH(8); break;
    case 16: AZ_PAGED_LAUNCH(16); break;
    case 32: AZ_PAGED_LAUNCH(32); break;
    case 64: AZ_PAGED_LAUNCH(64); break;
    case 128: AZ_PAGED_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef AZ_PAGED_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool, const int* tables,
                                   const int* lengths, float* out, int rows,
                                   int nh, int hd, int bl, int n_table,
                                   int parts, int per_part, float scale,
                                   void* stream) {
  return launch<float>(q, k_pool, v_pool, nullptr, nullptr, tables, lengths,
                       out, rows, nh, hd, bl, n_table, parts, per_part, scale,
                       stream);
}

extern "C" int paged_attention_int8(const float* q, const int8_t* k_pool,
                                    const int8_t* v_pool,
                                    const float* k_scale,
                                    const float* v_scale, const int* tables,
                                    const int* lengths, float* out, int rows,
                                    int nh, int hd, int bl, int n_table,
                                    int parts, int per_part, float scale,
                                    void* stream) {
  return launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                        out, rows, nh, hd, bl, n_table, parts, per_part,
                        scale, stream);
}
