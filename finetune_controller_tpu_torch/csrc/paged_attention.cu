// Paged-cache attention for decode and (suffix) prefill on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// finetune_controller_tpu/ops/pallas/paged_attention.py::_paged_kernel.
// Same contract: q (B, S, H, D); K/V pools (P, T, Hkv, D); page table
// (B, MP) int32; idx (B,) int32; out (B, S, H, D) in the pool dtype.  Query
// j of lane b attends the logical positions <= idx[b] + j (and < MP * T),
// where logical position p lives in pool page table[b][p / T] at offset
// p % T.
//
// What bounds it: the bytes of the attended K/V rows.  A decode step reads
// every attended K/V row once and does 2 * D FMAs per row and query head, far
// below the card's FLOP-per-byte balance point.  To reach the memory rate
// the card needs many blocks with many loads in flight each.
//
// The TPU kernel gathers a lane's whole cache into VMEM; at llama3-8b's
// 640-position lane that is ~1.3 MB, which does not fit the 227 KB of
// shared memory a block may use.  So a block streams pages instead, and
// reads the page-table slice it needs into shared memory first (so that no
// load waits on a table lookup in device memory).  Rows are the flat
// (query, head-of-group) rows of a (KV head, lane): row r = j * G + g is
// query j of head kvh * G + g, so one K/V row read serves all G heads of
// the group.  A row tile attends [0, idx + its last query + 1); positions
// past that are never loaded.
//
// Split over the key range (flash-decoding).  Decode has one row tile per
// (KV head, lane) and only B * Hkv of those (64 at 8 lanes, for 132 SMs), so
// the grid is (row tiles x splits, Hkv, B): a block divides its tile's range
// evenly into `splits` parts on chunk boundaries and walks only its own.
// With one split it writes out; with more it writes an f32 partial (running
// max, sum, unnormalised accumulator) to the caller's workspace, and
// paged_combine_kernel merges the partials of each row in fixed split order
// (no atomics: two launches give the same bits).  A split that starts past
// its tile's range (a short lane, positions past idx + S - 1) loads nothing
// and leaves max -inf and sum 0, which the merge skips, so no empty max turns
// into a NaN.
//
// Kernels, chosen by dtype and R = S * G, the rows per (KV head, lane):
//   * bf16: paged_attention_tc on the tensor cores, mma.sync.m16n8k16 (bf16
//     in, f32 accumulate), K and V of 64-position chunks double-buffered by
//     cp.async, S = Q Kᵀ with K's fragments read from its rows, O += P V
//     with V's through ldmatrix.trans, p rounded to bf16 for the PV product.
//     Decode (R <= DECODE_ROWS; llama3-8b has R = G = 4): one 16-row tile
//     per block, its 4 warps taking 16 keys each of every chunk and merging
//     their partials through shared memory at the end, with the range split
//     across blocks.  Prefill (R > DECODE_ROWS): 64-row tiles, 16 rows a
//     warp, every warp on every key, one split; the last row tiles attend
//     the most keys, so they get the lowest block indices and start first.
//     A suffix prefill after a prefix hit starts at idx > 0.  Chunks that
//     every row of the tile sees whole skip the per-element mask.
//   * f32: paged_split_kernel on the CUDA cores (results differ from the
//     plain path only in summation order), also split: 4, 8 or 16 rows a
//     block, 32-position chunks with NST - 1 in flight by cp.async ahead of
//     the one computed; lane t of a warp takes key t over all of D for the
//     warp's rows (rows padded by 16 bytes, so 8 neighbouring lanes'
//     16-byte reads hit distinct banks), and in the PV product lane l owns
//     output dims [l * D / 32, (l + 1) * D / 32).
//
// Numerics.  The plain path (the reference's op sequence) rounds the score
// einsum and the probabilities to the storage dtype and normalises before
// the PV product; the kernels keep scores in f32 and normalise at the end.
// They are therefore held to a stated tolerance against the plain path, not
// to bit identity (ops/kernels/paged_attention.py, TOLERANCE).  Like the
// plain path they scale q by D^-0.5 and round the product to the storage
// dtype before the dot products.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/kernels/paged_attention.py; launches on the caller's stream, allocates
// nothing (the caller passes the split workspace) and returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int NW = 4;            // warps per block
constexpr int NT = NW * 32;
constexpr int CH = 32;           // key positions per chunk of the split kernel: one per lane
constexpr int DECODE_ROWS = 16;  // R up to which bf16 runs the decode design

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Page-table entries [first, last] of a lane into shared memory, so that
// no cp.async waits on a global load for its address.
__device__ __forceinline__ void load_pages(int* pages_s, const int* table_row, int first,
                                           int last) {
  for (int i = threadIdx.x; i <= last - first; i += NT) pages_s[i] = table_row[first + i];
}

// K and V rows of logical positions [c0, c0 + n) of KV head kvh of one lane
// into shared-memory rows of `ld` elements, by cp.async; pages_s holds the
// lane's table from page `first`.  Positions at or past `end` fill zeros
// (so a masked probability never meets a stale value).
template <typename T, int D>
__device__ __forceinline__ void load_chunk(T* k_dst, T* v_dst, int ld, const T* k_pool,
                                           const T* v_pool, const int* pages_s, int first,
                                           int page_tokens, int Hkv, int kvh, int c0, int n,
                                           int end) {
  constexpr int VEC = 16 / sizeof(T), VPR = D / VEC;
  for (int e = threadIdx.x; e < n * VPR; e += NT) {
    const int t = e / VPR, c = (e % VPR) * VEC, pos = c0 + t;
    const bool in = pos < end;
    size_t off = 0;
    if (in) {
      const int page = pages_s[pos / page_tokens - first];
      off = (((size_t)page * page_tokens + pos % page_tokens) * Hkv + kvh) * D + c;
    }
    cp_async16(k_dst + t * ld + c, k_pool + off, in ? 16 : 0);
    cp_async16(v_dst + t * ld + c, v_pool + off, in ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int D> struct Split {
  static constexpr int VEC = 4, LD = D + VEC, DPL = D / 32;
  static constexpr size_t STAGE = 2 * (size_t)CH * LD * sizeof(float);  // K and V chunk
  static constexpr int NST = STAGE <= 20480 ? 4 : (STAGE <= 40960 ? 3 : 2);
  // + the page-table slice of a split: at most MP entries
  static size_t smem(int rows, int MP) {
    return NST * STAGE + (size_t)rows * D * sizeof(float) + (size_t)MP * sizeof(int);
  }
};

// Block (row tile x splits + split, kvh, b); warp w owns the flat rows
// row0 + w * RPW .. + RPW - 1 of the tile.  ws_ml / ws_acc: partials
// (B, Hkv, splits, R) x {(max, sum), D}, unused with one split.
template <int D, int RPW>
__global__ void __launch_bounds__(NT)
paged_split_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                   const float* __restrict__ v_pool, const int* __restrict__ table,
                   const int* __restrict__ idx, float* __restrict__ out,
                   float2* __restrict__ ws_ml, float* __restrict__ ws_acc, int S, int H, int Hkv,
                   int page_tokens, int MP, int splits, float scale) {
  using L = Split<D>;
  constexpr int ROWS = NW * RPW, NST = L::NST, LD = L::LD, DPL = L::DPL, VEC = L::VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kv_s = reinterpret_cast<float*>(smem_raw);  // stage st: K rows, then V rows
  float* q_s = reinterpret_cast<float*>(smem_raw + NST * L::STAGE);
  int* pages_s = reinterpret_cast<int*>(q_s + ROWS * D);

  const int split = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = H / Hkv, rows_total = S * G, row0 = tile * ROWS;
  const int lane_idx = idx[b];
  const int* table_row = table + (size_t)b * MP;

  // the tile's rows attend [0, kmax); this split walks [begin, end) of it
  const int last_row = min(row0 + ROWS, rows_total) - 1;
  const int kmax = min(MP * page_tokens, lane_idx + last_row / G + 1);
  const int per = (kmax + splits * CH - 1) / (splits * CH) * CH;
  const int begin = split * per, end = min(kmax, begin + per);
  const int n_chunks = begin < end ? (end - begin + CH - 1) / CH : 0;
  const size_t part = ((size_t)b * Hkv + kvh) * splits + split;  // partial row block

  if (n_chunks == 0) {  // past the range: an empty partial
    for (int i = threadIdx.x; i < ROWS; i += NT)
      if (row0 + i < rows_total)
        ws_ml[part * rows_total + row0 + i] = make_float2(-INFINITY, 0.f);
    return;
  }
  const int first = begin / page_tokens;
  load_pages(pages_s, table_row, first, (end - 1) / page_tokens);
  __syncthreads();

#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < n_chunks) {
      float* k_s = kv_s + (size_t)st * 2 * CH * LD;
      load_chunk<float, D>(k_s, k_s + CH * LD, LD, k_pool, v_pool, pages_s, first, page_tokens, Hkv,
                       kvh, begin + st * CH, CH, end);
    }
    cp_async_commit();
  }

  // scaled queries of the tile (in f32 the plain path's rounding to the
  // storage dtype changes nothing)
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = row0 + e / D, d = e % D;
    float val = 0.f;
    if (r < rows_total) {
      const int j = r / G, h = kvh * G + r % G;
      val = q[((size_t)(b * S + j) * H + h) * D + d] * scale;
    }
    q_s[e] = val;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];  // l: this lane's share of the sum
  int qlim[RPW];                         // last position each row attends
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
    qlim[i] = lane_idx + min(row0 + warp * RPW + i, rows_total - 1) / G;
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // chunk c landed for every thread; chunk c - 1 is consumed
    {
      const int nxt = c + NST - 1;
      if (nxt < n_chunks) {
        float* k_s = kv_s + (size_t)(nxt % NST) * 2 * CH * LD;
        load_chunk<float, D>(k_s, k_s + CH * LD, LD, k_pool, v_pool, pages_s, first, page_tokens,
                         Hkv, kvh, begin + nxt * CH, CH, end);
      }
      cp_async_commit();
    }
    const float* k_s = kv_s + (size_t)(c % NST) * 2 * CH * LD;
    const float* v_s = k_s + CH * LD;
    const int pos = begin + c * CH + lane;

    float dot[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) dot[i] = 0.f;
    const float* kr = k_s + lane * LD;
#pragma unroll 4
    for (int cc = 0; cc < D; cc += VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + cc);
      const float* kv = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + (warp * RPW + i) * D + cc);
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv = qr[e / 4];
          dot[i] = fmaf(qv.x, kv[e], dot[i]);
          dot[i] = fmaf(qv.y, kv[e + 1], dot[i]);
          dot[i] = fmaf(qv.z, kv[e + 2], dot[i]);
          dot[i] = fmaf(qv.w, kv[e + 3], dot[i]);
        }
      }
    }

    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float sv = (pos < end && pos <= qlim[i]) ? dot[i] : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // nothing attended yet
      p[i] = expf(sv - m_use);
      const float alpha = expf(m[i] - m_use);
      l[i] = l[i] * alpha + p[i];
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
    }
#pragma unroll 4
    for (int t = 0; t < CH; ++t) {
      const float* vr = v_s + t * LD + lane * DPL;
      float vv[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d) vv[d] = vr[d];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pt = __shfl_sync(0xffffffffu, p[i], t);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(pt, vv[d], acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const float l_row = warp_sum(l[i]);
    const int r = row0 + warp * RPW + i;
    if (r >= rows_total) continue;
    if (splits == 1) {  // the whole range: position 0 is attended, so l_row > 0
      const int j = r / G, h = kvh * G + r % G;
      const float inv = 1.f / l_row;
      float* o = out + ((size_t)(b * S + j) * H + h) * D + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) o[d] = acc[i][d] * inv;
    } else {
      const size_t at = part * rows_total + r;
      if (lane == 0) ws_ml[at] = make_float2(m[i], l_row);
      if (m[i] != -INFINITY) {
        float* a = ws_acc + at * D + lane * DPL;
#pragma unroll
        for (int d = 0; d < DPL; ++d) a[d] = acc[i][d];
      }
    }
  }
}

// One warp per (lane, KV head, flat row): the partials of every split in
// split order, out = sum_s w_s acc_s / sum_s w_s l_s with w_s = exp(m_s - M).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_combine_kernel(const float2* __restrict__ ws_ml, const float* __restrict__ ws_acc,
                     T* __restrict__ out, int B, int S, int H, int Hkv, int splits) {
  constexpr int DPL = D / 32;
  const int G = H / Hkv, rows_total = S * G;
  const int64_t w = (int64_t)blockIdx.x * NW + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (int64_t)B * Hkv * rows_total) return;
  const int r = (int)(w % rows_total);
  const int64_t bk = w / rows_total;  // b * Hkv + kvh
  const int kvh = (int)(bk % Hkv), b = (int)(bk / Hkv);
  const size_t first = (size_t)bk * splits * rows_total + r;  // split s at first + s * rows_total

  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ws_ml[first + (size_t)s * rows_total].x);
  float l = 0.f, acc[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t at = first + (size_t)s * rows_total;
    const float2 ml = ws_ml[at];
    if (ml.x == -INFINITY) continue;  // an empty split
    const float wt = expf(ml.x - M);
    l += wt * ml.y;
    const float* a = ws_acc + at * D + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] = fmaf(wt, a[d], acc[d]);
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  const int j = r / G, h = kvh * G + r % G;
  T* o = out + ((size_t)(b * S + j) * H + h) * D + lane * DPL;
#pragma unroll
  for (int d = 0; d < DPL; ++d) o[d] = from_f32<T>(acc[d] * inv);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16 x 16, row fragment) b (16 x 8, column fragment)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices, transposed: lanes 8i .. 8i + 7 give the row
// addresses of matrix i, and matrix i lands in b[i] as a column fragment.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&b)[4], const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, bool KEYS> struct Tc {
  // KEYS: one 16-row tile shared by the 4 warps, which split each chunk's
  // keys (decode); else 16 rows a warp, every warp on every key (prefill)
  static constexpr int BM = KEYS ? 16 : 16 * NW, BK = 64, LD = D + 8;  // rows padded by 16 bytes
  static constexpr int WK = KEYS ? BK / NW : BK;                       // keys a warp takes per chunk
  // queries, two stages of K and V, the page-table slice (at most MP entries)
  static size_t smem(int MP) {
    return ((size_t)BM * LD + 4 * (size_t)BK * LD) * sizeof(bf16) + (size_t)MP * sizeof(int);
  }
};

// Block (row tile x splits + split, kvh, b).  A warp keeps its rows as mma
// fragments: a thread holds rows g = lane / 4 and g + 8, columns 2 (lane %
// 4) and + 1 of every 8-column slice.  ws_ml / ws_acc as in
// paged_split_kernel (KEYS only; prefill runs with one split).
template <int D, bool KEYS>
__global__ void __launch_bounds__(NT)
paged_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                   const bf16* __restrict__ v_pool, const int* __restrict__ table,
                   const int* __restrict__ idx, bf16* __restrict__ out, float2* __restrict__ ws_ml,
                   float* __restrict__ ws_acc, int S, int H, int Hkv, int page_tokens, int MP,
                   int splits, float scale) {
  using C = Tc<D, KEYS>;
  constexpr int BM = C::BM, BK = C::BK, LD = C::LD, WK = C::WK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + BM * LD;  // stage st: K rows at kv_s + 2 st BK LD, then V rows
  int* pages_s = reinterpret_cast<int*>(kv_s + 4 * BK * LD);

  const int split = blockIdx.x % splits;
  const int tile = (int)(gridDim.x / splits) - 1 - (int)(blockIdx.x / splits);  // last rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int G = H / Hkv, rows_total = S * G, row0 = tile * BM;
  const int lane_idx = idx[b];
  const int* table_row = table + (size_t)b * MP;
  const int last_row = min(row0 + BM, rows_total) - 1;
  const int kmax = min(MP * page_tokens, lane_idx + last_row / G + 1);
  const int per = (kmax + splits * BK - 1) / (splits * BK) * BK;
  const int begin = split * per, end = min(kmax, begin + per);
  const int whole = min(end, lane_idx + row0 / G + 1);  // positions every row of the tile attends
  const int n_chunks = begin < end ? (end - begin + BK - 1) / BK : 0;
  const size_t part = ((size_t)b * Hkv + kvh) * splits + split;

  if (n_chunks == 0) {  // past the range: an empty partial
    for (int i = threadIdx.x; i < BM; i += NT)
      if (row0 + i < rows_total) ws_ml[part * rows_total + row0 + i] = make_float2(-INFINITY, 0.f);
    return;
  }
  const int first = begin / page_tokens;
  load_pages(pages_s, table_row, first, (end - 1) / page_tokens);
  __syncthreads();
  load_chunk<bf16, D>(kv_s, kv_s + BK * LD, LD, k_pool, v_pool, pages_s, first, page_tokens, Hkv,
                      kvh, begin, BK, end);
  cp_async_commit();

  // the tile's queries, scaled and rounded to bf16 like the plain path
  for (int e = threadIdx.x; e < BM * D / 8; e += NT) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8, R = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (R < rows_total) {
      const int j = R / G, h = kvh * G + R % G;
      const uint4 raw = *reinterpret_cast<const uint4*>(q + ((size_t)(b * S + j) * H + h) * D + c);
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
      bf16* y = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = __float2bfloat16(__bfloat162float(x[i]) * scale);
    }
    *reinterpret_cast<uint4*>(q_s + r * LD + c) = v;
  }

  const int wrow = KEYS ? 0 : 16 * warp;  // the warp's first row in the tile
  const int wkey = KEYS ? WK * warp : 0;  // the warp's first key in a chunk
  const int rl[2] = {wrow + g, wrow + g + 8};
  int qlim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qlim[r] = lane_idx + min(row0 + rl[r], rows_total - 1) / G;
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = begin + c * BK;
    if (c + 1 < n_chunks) {
      bf16* nk = kv_s + (size_t)((c + 1) & 1) * 2 * BK * LD;
      load_chunk<bf16, D>(nk, nk + BK * LD, LD, k_pool, v_pool, pages_s, first, page_tokens, Hkv,
                          kvh, k0 + BK, BK, end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and the queries) visible to every warp
    const bf16* k_s = kv_s + (size_t)(c & 1) * 2 * BK * LD + wkey * LD;
    const bf16* v_s = k_s + BK * LD;
    const int kw = k0 + wkey;  // position of the warp's first key

    float s[WK / 8][4];
#pragma unroll
    for (int n = 0; n < WK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(q_s + rl[0] * LD + kk + 2 * t4);
      a[1] = ld32(q_s + rl[1] * LD + kk + 2 * t4);
      a[2] = ld32(q_s + rl[0] * LD + kk + 8 + 2 * t4);
      a[3] = ld32(q_s + rl[1] * LD + kk + 8 + 2 * t4);
#pragma unroll
      for (int n = 0; n < WK / 8; ++n) {
        const bf16* kr = k_s + (8 * n + g) * LD + kk + 2 * t4;
        mma(s[n], a, ld32(kr), ld32(kr + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
    const bool masked = kw + WK > whole;
#pragma unroll
    for (int n = 0; n < WK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kp = kw + 8 * n + 2 * t4 + (e & 1);
        if (masked && !(kp < end && kp <= qlim[r])) s[n][e] = -INFINITY;
        mx[r] = fmaxf(mx[r], s[n][e]);
      }
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // nothing attended yet
      alpha[r] = expf(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < WK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - mu[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = v_s + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vrow + 16 * np);
        mma(o[2 * np], a, bv[0], bv[1]);
        mma(o[2 * np + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // chunk c consumed before the next load overwrites its stage
  }

  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_row[r] = quad_sum(l[r]);

  if (!KEYS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = row0 + rl[r];
      if (R >= rows_total) continue;
      const int j = R / G, h = kvh * G + R % G;
      const float inv = 1.f / l_row[r];  // position 0 is attended: l_row > 0
      bf16* dst = out + ((size_t)(b * S + j) * H + h) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    return;
  }

  // merge the warps' partials of the 16 rows through shared memory (the
  // stages are free now): (max, sum) per warp and row, then the accumulators
  float2* red_ml = reinterpret_cast<float2*>(q_s);        // [NW][16]
  float* red_o = reinterpret_cast<float*>(kv_s);          // [NW][16][D]
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) red_ml[warp * 16 + rl[r]] = make_float2(m[r], l_row[r]);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red_o[(warp * 16 + rl[e >> 1]) * D + 8 * n + 2 * t4 + (e & 1)] = o[n][e];
  __syncthreads();
  for (int e = threadIdx.x; e < BM * D; e += NT) {
    const int r = e / D, d = e % D, R = row0 + r;
    if (R >= rows_total) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, red_ml[w * 16 + r].x);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float2 ml = red_ml[w * 16 + r];
      if (ml.x == -INFINITY) continue;  // the warp's keys were all masked
      const float wt = expf(ml.x - M);
      lsum += wt * ml.y;
      acc = fmaf(wt, red_o[(w * 16 + r) * D + d], acc);
    }
    if (splits == 1) {
      const int j = R / G, h = kvh * G + R % G;
      out[((size_t)(b * S + j) * H + h) * D + d] = __float2bfloat16(acc / lsum);
    } else {
      const size_t at = part * rows_total + R;
      if (d == 0) ws_ml[at] = make_float2(M, lsum);
      ws_acc[at * D + d] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k_pool, *v_pool;
  const int *table, *idx;
  void* out;
  float2* ws_ml;
  float* ws_acc;
  int B, S, H, Hkv, page_tokens, MP, splits;
  cudaStream_t stream;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

// The kernels take the opt-in maximum of dynamic shared memory once and
// launch with what the shape needs (the page-table slice grows with MP).
constexpr size_t MAX_SMEM = 232448;

// Partials of more than one split merge in paged_combine_kernel.
template <typename T, int D>
cudaError_t combine(const Args& a) {
  const int64_t warps = (int64_t)a.B * a.Hkv * a.S * (a.H / a.Hkv);
  paged_combine_kernel<T, D><<<(unsigned)((warps + NW - 1) / NW), NT, 0, a.stream>>>(
      a.ws_ml, a.ws_acc, static_cast<T*>(a.out), a.B, a.S, a.H, a.Hkv, a.splits);
  return cudaGetLastError();
}

template <int D, int RPW>
cudaError_t launch_split(const Args& a, float scale) {
  constexpr int ROWS = NW * RPW;
  const size_t smem = Split<D>::smem(ROWS, a.MP);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static bool ready = false;
  auto kernel = paged_split_kernel<D, RPW>;
  cudaError_t err = allow_smem(kernel, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  const int rows_total = a.S * (a.H / a.Hkv);
  const dim3 grid(((rows_total + ROWS - 1) / ROWS) * a.splits, a.Hkv, a.B);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k_pool),
      static_cast<const float*>(a.v_pool), a.table, a.idx, static_cast<float*>(a.out), a.ws_ml,
      a.ws_acc, a.S, a.H, a.Hkv, a.page_tokens, a.MP, a.splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return combine<float, D>(a);
}

template <int D, bool KEYS>
cudaError_t launch_tc(const Args& a, float scale) {
  using C = Tc<D, KEYS>;
  const size_t smem = C::smem(a.MP);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static bool ready = false;
  auto kernel = paged_attention_tc<D, KEYS>;
  cudaError_t err = allow_smem(kernel, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  const int rows_total = a.S * (a.H / a.Hkv);
  const dim3 grid(((rows_total + C::BM - 1) / C::BM) * a.splits, a.Hkv, a.B);
  kernel<<<grid, NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k_pool),
      static_cast<const bf16*>(a.v_pool), a.table, a.idx, static_cast<bf16*>(a.out), a.ws_ml,
      a.ws_acc, a.S, a.H, a.Hkv, a.page_tokens, a.MP, a.splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return combine<bf16, D>(a);
}

// bf16 on the tensor cores: decode (R <= DECODE_ROWS, one 16-row tile, the
// keys split across warps and blocks) or prefill (64-row tiles, one split);
// f32 on the split kernel with 4, 8 or 16 rows a block (1, 2 or 4 a warp).
template <typename T, int D>
cudaError_t launch(const Args& a) {
  const float scale = 1.0f / sqrtf((float)D);
  const int rows_total = a.S * (a.H / a.Hkv);
  if constexpr (sizeof(T) == 2) {
    if (rows_total <= DECODE_ROWS) return launch_tc<D, true>(a, scale);
    if (a.splits != 1) return cudaErrorInvalidValue;
    return launch_tc<D, false>(a, scale);
  } else {
    if (rows_total <= NW) return launch_split<D, 1>(a, scale);
    if (rows_total <= 2 * NW) return launch_split<D, 2>(a, scale);
    return launch_split<D, 4>(a, scale);
  }
}

template <typename T>
cudaError_t dispatch_dim(const Args& a, int D) {
  switch (D) {
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    case 256: return launch<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  splits >= 1 parts of the key range
// (1 for bf16 prefill); with more than one, ws_ml (B, Hkv, splits, S*G)
// float2 and ws_acc (B, Hkv, splits, S*G, D) float hold the partials.
// Returns a cudaError_t (0 = success).
int ftc_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                        const void* table, const void* idx, void* out, void* ws_ml, void* ws_acc,
                        int B, int S, int H, int Hkv, int D, int page_tokens, int MP, int dtype,
                        int splits, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || page_tokens <= 0 || MP <= 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (ws_ml == nullptr || ws_acc == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, static_cast<const int*>(table), static_cast<const int*>(idx),
               out, static_cast<float2*>(ws_ml), static_cast<float*>(ws_acc), B, S, H, Hkv,
               page_tokens, MP, splits, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch_dim<float>(a, D);
  if (dtype == 1) return (int)dispatch_dim<bf16>(a, D);
  return (int)cudaErrorInvalidValue;
}

const char* ftc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
