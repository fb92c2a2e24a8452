// Paged-cache attention for decode and (suffix) prefill on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// finetune_controller_tpu/ops/pallas/paged_attention.py::_paged_kernel.
// Same contract: q (B, S, H, D); K/V pools (P, T, Hkv, D); page table
// (B, MP) int32; idx (B,) int32; out (B, S, H, D) in the pool dtype.  Query
// j of lane b attends the logical positions <= idx[b] + j, where logical
// position p lives in pool page table[b][p / T] at offset p % T.
//
// What bounds it: the bytes of the live KV pages.  A decode step reads every
// attended K/V row once and does 2 * D FMAs per row and query head, far
// below the card's FLOP-per-byte balance point.
//
// Design.  The TPU kernel gathers a lane's whole cache into VMEM; at
// llama3-8b's 640-position lane that is ~1.3 MB, which does not fit the
// 227 KB of shared memory a block may use.  So instead:
//   * one thread block per (query tile, KV head, lane); a tile is NW * RPW
//     (query position, head-of-group) rows, and each warp owns RPW rows;
//   * the block reads its own page-table row (no scalar prefetch) and walks
//     the lane's positions in chunks of CH, loading each K/V row into shared
//     memory once for all G = H / Hkv query heads of the group;
//   * positions past the block's last attended one (idx + last query) are
//     never loaded: pages entirely beyond idx + S - 1 are skipped, which
//     changes nothing since their softmax weight is exactly zero;
//   * online softmax with f32 running max and sum, f32 accumulation.  In the
//     score phase lane t of a warp takes key t (and t + 32) over all of D
//     (shared-memory rows are padded by 16 bytes, so the 16-byte reads of 8
//     consecutive lanes hit distinct banks); in the PV phase lane l owns
//     output dims [l * D / 32, (l + 1) * D / 32).
//
// Numerics.  The plain path (the reference's op sequence) rounds the score
// einsum and the probabilities to the storage dtype and normalises before the
// PV product; an online softmax keeps scores and probabilities in f32 and
// normalises at the end.  The kernel is therefore held to a stated tolerance
// against the plain path, not to bit identity (PERF.md, "Tolerance").  Like
// the plain path it scales q by D^-0.5 and rounds the product to the storage
// dtype before the dot products.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/kernels/paged_attention.py; launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;   // warps per block
constexpr int CH = 64;  // key positions per chunk: two per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T, int D>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte vector
  static constexpr int VPR = D / VEC;          // vectors per K/V row
  static constexpr int KSTRIDE = D + VEC;      // padded shared-memory row
  static constexpr int DPL = D / 32;           // output dims per lane
};

template <typename T, int D, int RPW>
size_t smem_bytes() {
  using L = Layout<T, D>;
  return 2 * CH * L::KSTRIDE * sizeof(T)      // K and V chunk
         + NW * RPW * D * sizeof(float)       // scaled queries
         + NW * CH * sizeof(float);           // per-warp probabilities
}

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(NW * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ table,
                       const int* __restrict__ idx, T* __restrict__ out, int S, int H,
                       int Hkv, int page_tokens, int MP, float scale) {
  using L = Layout<T, D>;
  constexpr int ROWS = NW * RPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + CH * L::KSTRIDE;
  float* q_s = reinterpret_cast<float*>(v_s + CH * L::KSTRIDE);
  float* p_s = q_s + ROWS * D;

  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = H / Hkv;
  const int rows_total = S * G;
  const int row0 = tile * ROWS;  // flat row r -> (query j = r / G, head kvh * G + r % G)
  const int lane_idx = idx[b];
  const int* table_row = table + (size_t)b * MP;

  // scaled queries of this tile, rounded through T like the plain path
  for (int e = threadIdx.x; e < ROWS * D; e += NW * 32) {
    const int r = row0 + e / D, d = e % D;
    float val = 0.f;
    if (r < rows_total) {
      const int j = r / G, h = kvh * G + r % G;
      val = to_f32(from_f32<T>(to_f32(q[((size_t)(b * S + j) * H + h) * D + d]) * scale));
    }
    q_s[e] = val;
  }

  // keys [0, kmax) are attended by some row of the tile
  const int last_row = min(row0 + ROWS, rows_total) - 1;
  const int kmax = min(MP * page_tokens, lane_idx + last_row / G + 1);

  float m[RPW], l[RPW], acc[RPW][L::DPL];
  int qlim[RPW];  // last key position each row attends
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < L::DPL; ++d) acc[i][d] = 0.f;
    qlim[i] = lane_idx + min(row0 + warp * RPW + i, rows_total - 1) / G;
  }

  for (int c0 = 0; c0 < kmax; c0 += CH) {
    const int nvalid = min(CH, kmax - c0);
    __syncthreads();  // previous chunk fully consumed (and q_s written)
    for (int e = threadIdx.x; e < CH * L::VPR; e += NW * 32) {
      const int t = e / L::VPR, c = (e % L::VPR) * L::VEC;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (t < nvalid) {
        const int pos = c0 + t;
        const int page = table_row[pos / page_tokens];
        const size_t off =
            (((size_t)page * page_tokens + pos % page_tokens) * Hkv + kvh) * D + c;
        kv = *reinterpret_cast<const uint4*>(k_pool + off);
        vv = *reinterpret_cast<const uint4*>(v_pool + off);
      }
      *reinterpret_cast<uint4*>(k_s + t * L::KSTRIDE + c) = kv;
      *reinterpret_cast<uint4*>(v_s + t * L::KSTRIDE + c) = vv;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float* qr = q_s + (warp * RPW + i) * D;
      float s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = lane + 32 * u;
        const T* kr = k_s + t * L::KSTRIDE;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += L::VEC) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
          const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < L::VEC; ++e) dot = fmaf(qr[c + e], to_f32(kv[e]), dot);
        }
        s[u] = (t < nvalid && c0 + t <= qlim[i]) ? dot : -INFINITY;
      }
      // key 0 is attended by every row, so m is finite after the first chunk
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      m[i] = m_new;
      p_s[warp * CH + lane] = p0;
      p_s[warp * CH + lane + 32] = p1;
      __syncwarp();
#pragma unroll
      for (int d = 0; d < L::DPL; ++d) acc[i][d] *= alpha;
      for (int t = 0; t < nvalid; ++t) {
        const float p = p_s[warp * CH + t];
        const T* vr = v_s + t * L::KSTRIDE + lane * L::DPL;
#pragma unroll
        for (int d = 0; d < L::DPL; ++d) acc[i][d] = fmaf(p, to_f32(vr[d]), acc[i][d]);
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    if (r >= rows_total) continue;
    const int j = r / G, h = kvh * G + r % G;
    const float inv = 1.f / l[i];
    T* o = out + ((size_t)(b * S + j) * H + h) * D + lane * L::DPL;
#pragma unroll
    for (int d = 0; d < L::DPL; ++d) o[d] = from_f32<T>(acc[i][d] * inv);
  }
}

template <typename T, int D, int RPW>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* table,
                   const int* idx, void* out, int B, int S, int H, int Hkv, int page_tokens,
                   int MP, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, D, RPW>;
  const size_t smem = smem_bytes<T, D, RPW>();
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int rows_total = S * (H / Hkv);
  const dim3 grid((rows_total + NW * RPW - 1) / (NW * RPW), Hkv, B);
  kernel<<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      table, idx, static_cast<T*>(out), S, H, Hkv, page_tokens, MP,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rows(const void* q, const void* k_pool, const void* v_pool,
                          const int* table, const int* idx, void* out, int B, int S, int H,
                          int Hkv, int page_tokens, int MP, cudaStream_t stream) {
  const int rows_total = S * (H / Hkv);
  if (rows_total <= NW)
    return launch<T, D, 1>(q, k_pool, v_pool, table, idx, out, B, S, H, Hkv, page_tokens, MP, stream);
  if (rows_total <= 2 * NW)
    return launch<T, D, 2>(q, k_pool, v_pool, table, idx, out, B, S, H, Hkv, page_tokens, MP, stream);
  return launch<T, D, 4>(q, k_pool, v_pool, table, idx, out, B, S, H, Hkv, page_tokens, MP, stream);
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k_pool, const void* v_pool,
                         const int* table, const int* idx, void* out, int B, int S, int H,
                         int Hkv, int D, int page_tokens, int MP, cudaStream_t stream) {
  switch (D) {
    case 64:
      return dispatch_rows<T, 64>(q, k_pool, v_pool, table, idx, out, B, S, H, Hkv, page_tokens, MP, stream);
    case 128:
      return dispatch_rows<T, 128>(q, k_pool, v_pool, table, idx, out, B, S, H, Hkv, page_tokens, MP, stream);
    case 256:
      return dispatch_rows<T, 256>(q, k_pool, v_pool, table, idx, out, B, S, H, Hkv, page_tokens, MP, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int ftc_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                        const void* table, const void* idx, void* out, int B, int S, int H,
                        int Hkv, int D, int page_tokens, int MP, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || page_tokens <= 0 || MP <= 0)
    return (int)cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(table);
  const int* ix = static_cast<const int*>(idx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(q, k_pool, v_pool, tbl, ix, out, B, S, H, Hkv, D, page_tokens, MP, st);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(q, k_pool, v_pool, tbl, ix, out, B, S, H, Hkv, D, page_tokens, MP, st);
  return (int)cudaErrorInvalidValue;
}

const char* ftc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
