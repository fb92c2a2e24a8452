// Flash attention for training on Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of
// finetune_controller_tpu/ops/pallas/flash_attention.py:
//   wg::flash_fwd_wg / flash_fwd_kernel         <- _fwd_kernel (pallas_call in _flash_forward)
//   wg::flash_bwd_dq_wg / flash_bwd_dq_kernel   <- _bwd_dq_kernel (first in _flash_backward)
//   wg::flash_bwd_dkv_wg / flash_bwd_dkv_kernel <- _bwd_dkv_kernel (second in _flash_backward)
// (the bf16 / the f32 kernel of each, for head dims 64, 128 and 256).
// Same contract: q, dO, out (B, S, H, D); k, v (B, S, Hkv, D) with head h
// reading KV head h / (H / Hkv); optional int32 segment ids (B, S) for the
// queries and for the keys; causal or full attention; lse and delta
// (B, H, S) f32.  A (query, key) pair is live iff the key is inside the
// sequence, (causal) key <= query and (segments) the two ids are equal.
// Probabilities are zeroed under the mask explicitly, so a fully masked row
// gets l = 0, out = 0, lse = f32_min + log(1e-30) and zero gradients.
//
// What bounds them on this card: operations.  At training shapes (S = 2048,
// D = 128) a block does 2 * D FLOP per (query, key) pair per product on tiles
// it reuses from shared memory 32-64 times; the bytes (each input read once)
// are ~30x below the operations even at the tensor-core rate.  In a packed
// batch only the pairs inside one document count, so the work the data
// needs is below the causal square.
//
// Two paths, chosen by dtype:
//   * bf16 (the training path): Hopper kernels, namespace wg.  A producer
//     warp keeps TMA loads of the next tiles in flight through a ring of
//     shared-memory stages while consumer warpgroups run wgmma on the
//     current one; the tile pairs whose documents cannot meet, or that lie
//     past the causal frontier, are skipped (described above namespace wg);
//   * f32 runs its products as FMAs on the CUDA cores (the card's 67 TFLOP/s
//     f32 rate), so f32 results differ from the plain version only in
//     summation order.
//
// Design, both paths:
//   * one block per (query tile, query head, batch row) for the forward and
//     dQ, one per (key tile, KV head, batch row) for dK/dV; the sequential
//     grid axis of the TPU kernels becomes a loop inside the block;
//   * the loops stop at the causal frontier: the forward and dQ walk key
//     tiles up to the tile's last query, dK/dV walk query tiles from the tile
//     holding its first key;
//   * dK/dV loops over every query head of its KV head's group inside the
//     block, so the GQA sum needs no atomics; no kernel uses atomics, so two
//     launches give the same bits;
//   * ragged tails are masked in the kernel: rows at or past S read as zero
//     (the TMA loads zero-fill them) and are never written (the TPU path pads
//     because its DMAs clamp).
// The f32 path stages tiles in shared memory, rows padded by 4 floats
// so the 16-byte reads of the 8 threads that share a row group hit distinct
// banks; each thread owns RM rows x RN columns of a score tile (rows
// rg + RG*i, columns cg + 8*j) and RM rows x D/8 columns of an accumulator
// (dims 4*cg + 32*k .. +3), and a row's 8 owners are 8 neighbouring lanes.
// Numerics follow the Pallas kernels: f32 scores times the scale, f32 exp
// (the TPU default for bf16 inputs is a bf16 exp; the wg kernels take it as
// exp2 of the score times scale * log2(e)), p rounded to the value dtype
// before the PV and dV products, ds rounded to the key/query dtype before
// the dQ and dK products (both only on the bf16 path: f32 rounds to
// itself), f32 accumulation, the scale applied to dQ and dK once at the end.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/kernels/flash_attention.py; each entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() after the launch
// (or an error of its own when a tensor map cannot be encoded or a bf16
// pointer is not 16-byte aligned).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -3.4028234663852886e38f;  // the reference's mask value
constexpr float L_FLOOR = 1e-30f;

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// Reductions over the 8 neighbouring lanes that own one row.
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + ROWS) of one head's (S, D) slice, whose rows lie
// `stride` elements apart, into shared memory with leading dimension D + 4.
// Rows at or past S read as zero.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int S,
                                          int64_t stride) {
  constexpr int VPR = D / 4;
  constexpr int LD = D + 4;
  for (int e = threadIdx.x; e < ROWS * VPR; e += NT) {
    const int r = e / VPR, c = (e % VPR) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) v = *reinterpret_cast<const float4*>(src + (int64_t)(row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = v;
  }
}

// acc[i][j] += sum_d A[rg + RG*i][d] * B[cg + 8*j][d]; A and B row-major f32
// with leading dimension D + 4.
template <int D, int RM, int RN, int RG>
__device__ __forceinline__ void mm_nt(float (&acc)[RM][RN], const float* A, const float* B,
                                      int rg, int cg) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = *reinterpret_cast<const float4*>(A + (rg + RG * i) * LD + d);
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = *reinterpret_cast<const float4*>(B + (cg + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][4k + e] += sum_{c < NC} P[rg + RG*i][c] * V[c][4*cg + 32*k + e]; P
// row-major with leading dimension LDP, V row-major with D + 4.
template <int D, int RM, int NC, int LDP, int RG>
__device__ __forceinline__ void mm_nn(float (&acc)[RM][D / 8], const float* P, const float* V,
                                      int rg, int cg) {
  constexpr int LD = D + 4, KC = D / 32;
#pragma unroll 2
  for (int c = 0; c < NC; c += 4) {
    float4 p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) p[i] = *reinterpret_cast<const float4*>(P + (rg + RG * i) * LDP + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(V + (c + e) * LD + 4 * cg + 32 * k);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float pe = comp(p[i], e);
          acc[i][4 * k + 0] = fmaf(pe, v.x, acc[i][4 * k + 0]);
          acc[i][4 * k + 1] = fmaf(pe, v.y, acc[i][4 * k + 1]);
          acc[i][4 * k + 2] = fmaf(pe, v.z, acc[i][4 * k + 2]);
          acc[i][4 * k + 3] = fmaf(pe, v.w, acc[i][4 * k + 3]);
        }
      }
    }
  }
}

// Rows rg + RG*i of an accumulator, times mul[i], into dst rows row0 + ...
template <int D, int RM, int RG>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[RM][D / 8],
                                           const float (&mul)[RM], int row0, int S,
                                           int64_t stride, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + rg + RG * i;
    if (r >= S) continue;
    float* out = dst + (int64_t)r * stride + 4 * cg;
#pragma unroll
    for (int k = 0; k < D / 32; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[32 * k + e] = acc[i][4 * k + e] * mul[i];
  }
}

__device__ __forceinline__ void load_segments(int* dst, const int* seg, int b, int row0, int n,
                                              int S, int NT) {
  for (int r = threadIdx.x; r < n; r += NT)
    dst[r] = (row0 + r < S) ? seg[(int64_t)b * S + row0 + r] : 0;
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, query head, batch row)
// ---------------------------------------------------------------------------

template <int D> struct Fwd {
  static constexpr int NT = 128, BQ = 64, BK = 32, RG = NT / 8, RM = BQ / RG, RN = BK / 8;
  static constexpr int LD = D + 4, LDP = BK + 4;
  static constexpr size_t smem = ((size_t)(BQ + 2 * BK) * LD + BQ * LDP) * sizeof(float)
                                 + (BQ + BK) * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(Fwd<D>::NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, float* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int Hkv, float scale, int causal) {
  using C = Fwd<D>;
  constexpr int NT = C::NT, BQ = C::BQ, BK = C::BK, RG = C::RG, RM = C::RM, RN = C::RN;
  constexpr int LDP = C::LDP;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * C::LD;
  float* v_s = k_s + BK * C::LD;
  float* p_s = v_s + BK * C::LD;
  int* qseg_s = reinterpret_cast<int*>(p_s + BQ * LDP);
  int* kseg_s = qseg_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
  const float* qb = q + ((int64_t)b * S * H + h) * D;
  const float* kb = k + ((int64_t)b * S * Hkv + kvh) * D;
  const float* vb = v + ((int64_t)b * S * Hkv + kvh) * D;

  load_rows<D, BQ, NT>(q_s, qb, q0, S, qstride);
  if (qseg) load_segments(qseg_s, qseg, b, q0, BQ, S, NT);

  float m[RM], l[RM], acc[RM][D / 8];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q_s, qseg_s written)
    load_rows<D, BK, NT>(k_s, kb, k0, S, kstride);
    load_rows<D, BK, NT>(v_s, vb, k0, S, kstride);
    if (qseg) load_segments(kseg_s, kseg, b, k0, BK, S, NT);
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
    mm_nt<D, RM, RN, RG>(s, q_s, k_s, rg, cg);

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int rl = rg + RG * i, qp = q0 + rl;
      unsigned ok = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int cl = cg + 8 * j, kp = k0 + cl;
        const bool live = kp < S && (!causal || qp >= kp) && (!qseg || qseg_s[rl] == kseg_s[cl]);
        ok |= (unsigned)live << j;
        s[i][j] = live ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = ((ok >> j) & 1u) ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[rl * LDP + cg + 8 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mm_nn<D, RM, BK, LDP, RG>(acc, p_s, v_s, rg, cg);
  }

  float inv[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) inv[i] = 1.f / fmaxf(l[i], L_FLOOR);
  store_rows<D, RM, RG>(out + ((int64_t)b * S * H + h) * D, acc, inv, q0, S, qstride, rg, cg);
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + rg + RG * i;
      if (qp < S) lse[((int64_t)b * H + h) * S + qp] = m[i] + logf(fmaxf(l[i], L_FLOOR));
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (query tile, query head, batch row)
// ---------------------------------------------------------------------------

template <int D> struct Dq {
  static constexpr int NT = 128, BQ = 64, BK = 32, RG = NT / 8, RM = BQ / RG, RN = BK / 8;
  static constexpr int LD = D + 4, LDS = BK + 4;
  static constexpr size_t smem = ((size_t)(2 * BQ + 2 * BK) * LD + BQ * LDS) * sizeof(float)
                                 + (BQ + BK) * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(Dq<D>::NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ qseg, const int* __restrict__ kseg,
                    float* __restrict__ dq, int S, int H, int Hkv,
                    float scale, int causal) {
  using C = Dq<D>;
  constexpr int NT = C::NT, BQ = C::BQ, BK = C::BK, RG = C::RG, RM = C::RM, RN = C::RN;
  constexpr int LDS = C::LDS;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * C::LD;
  float* k_s = do_s + BQ * C::LD;
  float* v_s = k_s + BK * C::LD;
  float* ds_s = v_s + BK * C::LD;
  int* qseg_s = reinterpret_cast<int*>(ds_s + BQ * LDS);
  int* kseg_s = qseg_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
  const int64_t qoff = ((int64_t)b * S * H + h) * D;
  const float* kb = k + ((int64_t)b * S * Hkv + kvh) * D;
  const float* vb = v + ((int64_t)b * S * Hkv + kvh) * D;
  const int64_t row_stats = ((int64_t)b * H + h) * S;

  load_rows<D, BQ, NT>(q_s, q + qoff, q0, S, qstride);
  load_rows<D, BQ, NT>(do_s, dout + qoff, q0, S, qstride);
  if (qseg) load_segments(qseg_s, qseg, b, q0, BQ, S, NT);

  float lse_r[RM], delta_r[RM], acc[RM][D / 8];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + rg + RG * i;
    lse_r[i] = qp < S ? lse[row_stats + qp] : 0.f;
    delta_r[i] = qp < S ? delta[row_stats + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<D, BK, NT>(k_s, kb, k0, S, kstride);
    load_rows<D, BK, NT>(v_s, vb, k0, S, kstride);
    if (qseg) load_segments(kseg_s, kseg, b, k0, BK, S, NT);
    __syncthreads();

    float s[RM][RN], dp[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<D, RM, RN, RG>(s, q_s, k_s, rg, cg);
    mm_nt<D, RM, RN, RG>(dp, do_s, v_s, rg, cg);

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int rl = rg + RG * i, qp = q0 + rl;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int cl = cg + 8 * j, kp = k0 + cl;
        const bool live = kp < S && (!causal || qp >= kp) && (!qseg || qseg_s[rl] == kseg_s[cl]);
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[rl * LDS + cl] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    mm_nn<D, RM, BK, LDS, RG>(acc, ds_s, k_s, rg, cg);
  }

  float mul[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) mul[i] = scale;
  store_rows<D, RM, RG>(dq + qoff, acc, mul, q0, S, qstride, rg, cg);
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (key tile, KV head, batch row); the GQA group and the
// query tiles are walked inside the block
// ---------------------------------------------------------------------------

template <int D> struct Dkv {
  static constexpr int NT = 256, BK = 64, BQ = 32, RG = NT / 8, RM = BK / RG, RN = BQ / 8;
  static constexpr int LD = D + 4, LDP = BQ + 4;
  static constexpr size_t smem = ((size_t)(2 * BK + 2 * BQ) * LD + 2 * BK * LDP + 2 * BQ)
                                 * sizeof(float) + (BQ + BK) * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(Dkv<D>::NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ qseg, const int* __restrict__ kseg,
                     float* __restrict__ dk, float* __restrict__ dv, int S, int H, int Hkv,
                     float scale, int causal) {
  using C = Dkv<D>;
  constexpr int NT = C::NT, BQ = C::BQ, BK = C::BK, RG = C::RG, RM = C::RM, RN = C::RN;
  constexpr int LDP = C::LDP;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * C::LD;
  float* q_s = v_s + BK * C::LD;
  float* do_s = q_s + BQ * C::LD;
  float* p_s = do_s + BQ * C::LD;
  float* ds_s = p_s + BK * LDP;
  float* lse_s = ds_s + BK * LDP;
  float* delta_s = lse_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ);
  int* kseg_s = qseg_s + BQ;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
  const int64_t koff = ((int64_t)b * S * Hkv + kvh) * D;

  load_rows<D, BK, NT>(k_s, k + koff, k0, S, kstride);
  load_rows<D, BK, NT>(v_s, v + koff, k0, S, kstride);
  if (qseg) load_segments(kseg_s, kseg, b, k0, BK, S, NT);

  float dk_acc[RM][D / 8], dv_acc[RM][D / 8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // query tiles before the one holding key k0 see none of this block's keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t qoff = ((int64_t)b * S * H + h) * D;
    const int64_t row_stats = ((int64_t)b * H + h) * S;
    for (int q0 = q_begin; q0 < S; q0 += BQ) {
      __syncthreads();
      load_rows<D, BQ, NT>(q_s, q + qoff, q0, S, qstride);
      load_rows<D, BQ, NT>(do_s, dout + qoff, q0, S, qstride);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse[row_stats + q0 + r] : 0.f;
        delta_s[r] = in ? delta[row_stats + q0 + r] : 0.f;
      }
      if (qseg) load_segments(qseg_s, qseg, b, q0, BQ, S, NT);
      __syncthreads();

      // transposed tiles: rows are this block's keys, columns the queries
      float s[RM][RN], dp[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
      mm_nt<D, RM, RN, RG>(s, k_s, q_s, rg, cg);
      mm_nt<D, RM, RN, RG>(dp, v_s, do_s, rg, cg);

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int rl = rg + RG * i, kp = k0 + rl;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int cl = cg + 8 * j, qp = q0 + cl;
          const bool live = qp < S && kp < S && (!causal || qp >= kp) &&
                            (!qseg || qseg_s[cl] == kseg_s[rl]);
          const float p = live ? expf(s[i][j] * scale - lse_s[cl]) : 0.f;
          p_s[rl * LDP + cl] = p;
          ds_s[rl * LDP + cl] = p * (dp[i][j] - delta_s[cl]);
        }
      }
      __syncthreads();
      mm_nn<D, RM, BQ, LDP, RG>(dv_acc, p_s, do_s, rg, cg);
      mm_nn<D, RM, BQ, LDP, RG>(dk_acc, ds_s, q_s, rg, cg);
    }
  }

  float one[RM], sc[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    one[i] = 1.f;
    sc[i] = scale;
  }
  store_rows<D, RM, RG>(dk + koff, dk_acc, sc, k0, S, kstride, rg, cg);
  store_rows<D, RM, RG>(dv + koff, dv_acc, one, k0, S, kstride, rg, cg);
}

// ---------------------------------------------------------------------------
// bf16 forward, dQ and dK/dV on Hopper: wgmma fed by a TMA ring
//
// A block is NC consumer warpgroups plus one producer warpgroup.  One warp
// of the producer issues the TMA loads of each live tile into a ring of ST
// stages (a full and an empty mbarrier each) and copies the tile's per-row
// scalars (segment ids, lse, delta) beside it; the consumers run wgmma
// (bf16 in, f32 accumulate) on the stage, then release it.  setmaxnreg
// moves registers from the producer to the consumers.
//
// Tiles land with the 128-byte swizzle and are read by the wgmma
// descriptors as each product needs them (sm90.cuh), so nothing is staged
// transposed:
//   forward  S = Q Kᵀ       Q, K K-major     O += P V     V MN-major
//   dQ       S = Q Kᵀ       Q, K K-major     dQ += dS K   K MN-major
//            dP = dO Vᵀ     dO, V K-major
//   dK/dV    Sᵀ = K Qᵀ      K, Q K-major     dV += Pᵀ dO  dO MN-major
//            dPᵀ = V dOᵀ    V, dO K-major    dK += dSᵀ Q  Q MN-major
// P, dS, Pᵀ and dSᵀ go from the accumulator into the next product's
// register A fragments, rounded to bf16 as the Pallas kernels round p and ds.
//
// Tile skipping: before the split into roles every warp of the block reads
// the segment ids of its tile pairs and marks a pair dead when its key tile
// lies past the causal frontier or when the [min, max] segment ids of the
// query and key tiles are disjoint (the predicate of ``live_tiles`` in
// ops/kernels/flash_attention.py).  One warp compacts the live pairs into a
// list that producer and consumers walk in the same order.  A live pair is
// further marked for the causal / bounds mask and for the segment compare,
// so a pair fully inside one document and below the diagonal runs unmasked.
//
// Sizes: two consumer warpgroups, so a block holds 128 query rows (forward,
// dQ) or 128 key rows (dK/dV) and reuses each streamed tile for both; key
// tiles of 128 (forward) and 64 (dQ, whose 64 x 128 dQ accumulator takes 64
// registers a thread beside S and dP, 32 each), query tiles of 64 (dK/dV,
// where dK and dV stay in registers, 2 x 64 a thread at D = 128).
// setmaxnreg gives the consumers 240 registers (forward, dQ) or 232 (dK/dV,
// whose producer also copies lse, delta and segment ids and keeps 40); 384
// threads launch at 168 each.
//
// Head dim 256 (Gemma) has tiles of its own: the 64 x 256 f32 accumulator of
// a consumer warpgroup takes 128 registers a thread, and the D = 128 rings
// would need 320-512 KiB of shared memory.  So at D = 256:
//   forward  key tiles of 64 in 2 stages (64 KiB of Q + 128 KiB);
//   dQ       one consumer warpgroup of 64 query rows (256 threads, no
//            setmaxnreg: up to 255 registers a thread), key tiles of 64 in
//            2 stages (64 KiB of Q and dO + 128 KiB);
//   dK/dV    a block of 64 key rows whose two consumer warpgroups split D:
//            each computes the whole Sᵀ and dPᵀ (reduced over all of D) and
//            keeps dK and dV for its 128 columns, so a thread holds 2 x 64
//            accumulators as at D = 128; query tiles of 64 in 2 stages
//            (64 KiB of K and V + 128 KiB).  The two Sᵀ / dPᵀ products run
//            twice per tile pair, 1.5x the operations of the four products.
// The O and dQ products of 256 columns are one m64n256k16 wgmma each.  Causal work grows with the query tile in the
// forward and dQ and shrinks with the key tile in dK/dV; the grid's y axis
// is ordered so the heaviest blocks get the lowest indices and start first,
// and the light ones fill the tail.
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int WG_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int LIVE = 1, BOUND_MASK = 2, SEG_MASK = 4;  // tile flags
constexpr int TILE_BITS = 24;                           // list entry: tile | flags << 24

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_pair(bf16* out, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(lo, hi);
}

// Reductions over the 4 lanes of a quad, which own one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// [min, max] of seg[base + r] over rows r in [r0, r1), reduced over the warp
// (0, 0 without segment ids).
__device__ __forceinline__ void seg_range(const int* seg, int64_t base, int r0, int r1, int lane,
                                          int& lo, int& hi) {
  if (seg == nullptr) {
    lo = hi = 0;
    return;
  }
  lo = INT_MAX;
  hi = INT_MIN;
  for (int r = r0 + lane; r < r1; r += 32) {
    const int v = seg[base + r];
    lo = min(lo, v);
    hi = max(hi, v);
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

__device__ __forceinline__ int tile_flags(int qlo, int qhi, int klo, int khi, bool bound) {
  if (qhi < klo || khi < qlo) return 0;
  const bool uniform = qlo == qhi && klo == khi && qlo == klo;
  return LIVE | (bound ? BOUND_MASK : 0) | (uniform ? 0 : SEG_MASK);
}

// Warp 0 packs the live entries of flags[0, n) into list; returns the count
// (to every lane of warp 0).
__device__ __forceinline__ int compact(const int* flags, int* list, int n, int lane) {
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int t = base + lane;
    const int f = t < n ? flags[t] : 0;
    const unsigned live = __ballot_sync(0xffffffffu, f & LIVE);
    if (f & LIVE) list[count + __popc(live & ((1u << lane) - 1u))] = t | (f << TILE_BITS);
    count += __popc(live);
  }
  return count;
}

// Flags of key tiles [0, nk) of BK rows for the query rows [q0, q_last],
// written by the block's warps in turn (forward and dQ).
template <int BK, int NT>
__device__ __forceinline__ void key_tile_flags(const int* qseg, const int* kseg, int b, int S,
                                               int q0, int q_last, int nk, int causal, int* flags,
                                               int warp, int lane) {
  int qlo, qhi;
  seg_range(qseg, (int64_t)b * S, q0, q_last + 1, lane, qlo, qhi);
  for (int t = warp; t < nk; t += NT / 32) {
    const int k_first = t * BK;
    int klo, khi;
    seg_range(kseg, (int64_t)b * S, k_first, min(k_first + BK, S), lane, klo, khi);
    const bool bound = (causal && k_first + BK - 1 > q0) || k_first + BK > S;
    if (lane == 0) flags[t] = tile_flags(qlo, qhi, klo, khi, bound);
  }
}

// Once the flags of n tiles are written: thread 0 initialises the barriers
// (bars[0] for the block's resident tiles, one arrival; the ring's full[s]
// = bars[1 + s], the 32 lanes of the producer warp; empty[s] = bars[1 + ST
// + s], one lane of each of the 4 NC consumer warps), warp 0 compacts the
// live tiles into `list`, and every thread gets their count.
template <int ST, int NC>
__device__ __forceinline__ int ring_setup(uint64_t* bars, const int* flags, int* list, int n,
                                          int* n_live, int warp, int lane) {
  if (threadIdx.x == 0) {
    sm90::bar_init(&bars[0], 1);
    for (int s = 0; s < ST; ++s) {
      sm90::bar_init(&bars[1 + s], 32);
      sm90::bar_init(&bars[1 + ST + s], 4 * NC);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    const int count = compact(flags, list, n, lane);
    if (lane == 0) *n_live = count;
  }
  __syncthreads();
  return *n_live;
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile of 64 NC rows, head, batch row)
// ---------------------------------------------------------------------------

template <int D> struct Fwd {
  static constexpr int NC = 2, BQ = 64 * NC, BK = D == 256 ? 64 : 128, ST = D == 64 ? 4 : 2;
  static constexpr int NT = WG_THREADS * (NC + 1), P = D / 64;
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr size_t K_OFF = Q_BYTES, KSEG_OFF = K_OFF + (size_t)ST * 2 * KV_BYTES;
  static constexpr size_t BAR_OFF = KSEG_OFF + ST * BK * sizeof(int);
  static constexpr size_t LIST_OFF = BAR_OFF + (1 + 2 * ST) * sizeof(uint64_t) + 16;
  // + 1024 to align the base; + the flags and list of n key tiles
  static size_t smem(int n) { return 1024 + LIST_OFF + 2 * (size_t)n * sizeof(int); }
};

template <int D>
__global__ void __launch_bounds__(Fwd<D>::NT, 1)
flash_fwd_wg(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ qseg,
             const int* __restrict__ kseg, bf16* __restrict__ out, float* __restrict__ lse,
             int S, int H, int Hkv, float scale, int causal) {
  using C = Fwd<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST, P = C::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(base);
  int* kseg_s = reinterpret_cast<int*>(base + C::KSEG_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);  // q, full[ST], empty[ST]
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;
  int* n_live = reinterpret_cast<int*>(empty + ST);
  int* flags = reinterpret_cast<int*>(base + C::LIST_OFF);

  const int nqt = gridDim.y;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * BQ;  // heaviest causal tiles launch first
  const int h = blockIdx.x % H, b = blockIdx.x / H, kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_last = min(q0 + BQ, S) - 1;
  const int nk = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  int* list = flags + nk;

  key_tile_flags<BK, C::NT>(qseg, kseg, b, S, q0, q_last, nk, causal, flags, warp, lane);
  const int n = ring_setup<ST, C::NC>(bars, flags, list, nk, n_live, warp, lane);
  const int wgi = threadIdx.x / WG_THREADS;

  if (wgi == C::NC) {  // producer
    sm90::regs_dec<24>();
    if (warp % 4 != 0) return;
    if (lane == 0) {
      sm90::bar_arrive_tx(&bars[0], C::Q_BYTES);
      for (int p = 0; p < P; ++p)
        sm90::tma_load_4d(q_s + p * BQ * 64, &tm_q, &bars[0], 64 * p, h, q0, b);
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % ST;
      sm90::bar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      const int k0 = (list[i] & ((1 << TILE_BITS) - 1)) * BK;
      if (kseg)
        for (int r = lane; r < BK; r += 32)
          kseg_s[s * BK + r] = k0 + r < S ? kseg[(int64_t)b * S + k0 + r] : 0;
      if (lane == 0) {
        sm90::bar_arrive_tx(&full[s], 2 * C::KV_BYTES);
        bf16* k_s = reinterpret_cast<bf16*>(base + C::K_OFF + (size_t)s * 2 * C::KV_BYTES);
        bf16* v_s = k_s + BK * D;
        for (int p = 0; p < P; ++p) {
          sm90::tma_load_4d(k_s + p * BK * 64, &tm_k, &full[s], 64 * p, kvh, k0, b);
          sm90::tma_load_4d(v_s + p * BK * 64, &tm_v, &full[s], 64 * p, kvh, k0, b);
        }
      } else {
        sm90::bar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns query rows q0 + 64 wgi .. + 63
  sm90::regs_inc<240>();
  const int wl = warp % 4, g = lane / 4, t4 = lane % 4;
  const int row[2] = {q0 + 64 * wgi + 16 * wl + g, q0 + 64 * wgi + 16 * wl + g + 8};
  int qs[2] = {0, 0};
  if (qseg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) qs[r] = row[r] < S ? qseg[(int64_t)b * S + row[r]] : 0;
  }
  const float c1 = scale * LOG2E;
  float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // Q K-major (this warpgroup's 64 rows); K K-major; V MN-major (LBO: next 64 columns)
  const uint64_t dq = sm90::desc(q_s + 64 * wgi * 64, 16, 1024);
  sm90::bar_wait(&bars[0], 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    const int entry = list[i], f = entry >> TILE_BITS;
    const int k0 = (entry & ((1 << TILE_BITS) - 1)) * BK;
    const bf16* k_s = reinterpret_cast<const bf16*>(base + C::K_OFF + (size_t)s * 2 * C::KV_BYTES);
    const uint64_t dk = sm90::desc(k_s, 16, 1024);
    const uint64_t dv = sm90::desc(k_s + BK * D, BK * 128, 1024);
    sm90::bar_wait(&full[s], (i / ST) & 1);

    float sc[BK / 2];
    sm90::fence_regs(sc);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<0, 0>(sc, sm90::desc_add(dq, (kk / 4) * BQ * 128 + (kk % 4) * 32),
                         sm90::desc_add(dk, (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
    sm90::mma_commit();
    sm90::mma_wait<0>();
    sm90::fence_regs(sc);

    // scores in the log2 domain; masked ones -inf
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * j + 2 * t4 + (e & 1), kp = k0 + c;
        bool ok = true;
        if (f & BOUND_MASK) ok = kp < S && (!causal || row[r] >= kp);
        if (f & SEG_MASK) ok = ok && qs[r] == kseg_s[s * BK + c];
        const float y = ok ? sc[4 * j + e] * c1 : -INFINITY;
        sc[4 * j + e] = y;
        mx[r] = fmaxf(mx[r], y);
      }
    float alpha[2], sum[2] = {0.f, 0.f}, m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing live yet
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * j + e] - m_use[e >> 1]);
        sc[4 * j + e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) pf[kk][x] = pack(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

    sm90::fence_regs(o);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::mma_rs<1>(o, pf[kk], sm90::desc_add(dv, kk * 16 * 128), 1);
    sm90::mma_commit();
    sm90::mma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(pf);
    if (lane == 0) sm90::bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row[r];
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[r], L_FLOOR);
    bf16* dst = out + (((int64_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(dst + 8 * j + 2 * t4, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t4 == 0)
      lse[((int64_t)b * H + h) * S + qp] =
          l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : NEG_INF + logf(L_FLOOR);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (key tile of 64 NC rows, KV head, batch row); the G
// query heads of the KV head and their live query tiles are walked inside
// the block, so the GQA sum stays in registers (no atomics)
// ---------------------------------------------------------------------------

template <int D> struct Dkv {
  // SPLIT: both consumer warpgroups own the block's BK key rows, each the
  // dK and dV of DH = D / 2 columns (D = 256); else each owns 64 rows
  static constexpr bool SPLIT = D == 256;
  static constexpr int NC = 2, BK = SPLIT ? 64 : 64 * NC, BQ = 64, ST = SPLIT ? 2 : 3;
  static constexpr int DH = SPLIT ? D / NC : D;
  static constexpr int NT = WG_THREADS * (NC + 1), P = D / 64;
  static constexpr uint32_t KV_BYTES = BK * D * 2, QT_BYTES = BQ * D * 2;
  static constexpr size_t Q_OFF = 2 * (size_t)KV_BYTES;
  static constexpr size_t ROW_OFF = Q_OFF + (size_t)ST * 2 * QT_BYTES;  // lse, delta, qseg
  static constexpr size_t BAR_OFF = ROW_OFF + 3 * ST * BQ * sizeof(float);
  static constexpr size_t LIST_OFF = BAR_OFF + (1 + 2 * ST) * sizeof(uint64_t) + 16;
  static size_t smem(int n) { return 1024 + LIST_OFF + 2 * (size_t)n * sizeof(int); }
};

template <int D>
__global__ void __launch_bounds__(Dkv<D>::NT, 1)
flash_bwd_dkv_wg(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, int S, int H, int Hkv,
                 float scale, int causal) {
  using C = Dkv<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST, P = C::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* k_s = reinterpret_cast<bf16*>(base);
  bf16* v_s = k_s + BK * D;
  float* lse_s = reinterpret_cast<float*>(base + C::ROW_OFF);  // [ST][BQ] each
  float* delta_s = lse_s + ST * BQ;
  int* qseg_s = reinterpret_cast<int*>(delta_s + ST * BQ);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);  // kv, full[ST], empty[ST]
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;
  int* n_live = reinterpret_cast<int*>(empty + ST);
  int* flags = reinterpret_cast<int*>(base + C::LIST_OFF);

  const int k0 = blockIdx.y * BK;  // key tile 0 holds the most causal work: it launches first
  const int kvh = blockIdx.x % Hkv, b = blockIdx.x / Hkv, G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = (S + BQ - 1) / BQ;
  const int jb = causal ? k0 / BQ : 0;  // query tiles before it see none of these keys
  int* list = flags + (nq - jb);

  {  // flags of the live query tiles of this key tile
    int klo, khi;
    seg_range(kseg, (int64_t)b * S, k0, min(k0 + BK, S), lane, klo, khi);
    for (int j = jb + warp; j < nq; j += C::NT / 32) {
      const int qf = j * BQ;
      int qlo, qhi;
      seg_range(qseg, (int64_t)b * S, qf, min(qf + BQ, S), lane, qlo, qhi);
      const bool bound = (causal && qf < k0 + BK - 1) || qf + BQ > S || k0 + BK > S;
      if (lane == 0) flags[j - jb] = tile_flags(qlo, qhi, klo, khi, bound);
    }
  }
  const int n = ring_setup<ST, C::NC>(bars, flags, list, nq - jb, n_live, warp, lane);
  const int wgi = threadIdx.x / WG_THREADS;

  if (wgi == C::NC) {  // producer
    sm90::regs_dec<40>();
    if (warp % 4 != 0) return;
    if (lane == 0) {
      sm90::bar_arrive_tx(&bars[0], 2 * C::KV_BYTES);
      for (int p = 0; p < P; ++p) {
        sm90::tma_load_4d(k_s + p * BK * 64, &tm_k, &bars[0], 64 * p, kvh, k0, b);
        sm90::tma_load_4d(v_s + p * BK * 64, &tm_v, &bars[0], 64 * p, kvh, k0, b);
      }
    }
    int i = 0;
    for (int gi = 0; gi < G; ++gi) {
      const int h = kvh * G + gi;
      const float* lse_h = lse + ((int64_t)b * H + h) * S;
      const float* delta_h = delta + ((int64_t)b * H + h) * S;
      for (int jj = 0; jj < n; ++jj, ++i) {
        const int s = i % ST;
        sm90::bar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        const int q0 = (jb + (list[jj] & ((1 << TILE_BITS) - 1))) * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < S;
          lse_s[s * BQ + r] = in ? lse_h[q0 + r] : 0.f;
          delta_s[s * BQ + r] = in ? delta_h[q0 + r] : 0.f;
          if (qseg) qseg_s[s * BQ + r] = in ? qseg[(int64_t)b * S + q0 + r] : 0;
        }
        if (lane == 0) {
          sm90::bar_arrive_tx(&full[s], 2 * C::QT_BYTES);
          bf16* q_s = reinterpret_cast<bf16*>(base + C::Q_OFF + (size_t)s * 2 * C::QT_BYTES);
          bf16* do_s = q_s + BQ * D;
          for (int p = 0; p < P; ++p) {
            sm90::tma_load_4d(q_s + p * BQ * 64, &tm_q, &full[s], 64 * p, h, q0, b);
            sm90::tma_load_4d(do_s + p * BQ * 64, &tm_do, &full[s], 64 * p, h, q0, b);
          }
        } else {
          sm90::bar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns key rows k0 + r0 .. + 63 and the dK and
  // dV columns c0 .. c0 + DH - 1
  sm90::regs_inc<232>();
  constexpr int DH = C::DH;
  const int r0 = C::SPLIT ? 0 : 64 * wgi, c0 = C::SPLIT ? DH * wgi : 0;
  const int wl = warp % 4, g = lane / 4, t4 = lane % 4;
  const int row[2] = {k0 + r0 + 16 * wl + g, k0 + r0 + 16 * wl + g + 8};
  int ks[2] = {0, 0};
  if (kseg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) ks[r] = row[r] < S ? kseg[(int64_t)b * S + row[r]] : 0;
  }
  const float c1 = scale * LOG2E;
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
  // K and V K-major (this warpgroup's 64 rows)
  const uint64_t dka = sm90::desc(k_s + r0 * 64, 16, 1024);
  const uint64_t dva = sm90::desc(v_s + r0 * 64, 16, 1024);
  sm90::bar_wait(&bars[0], 0);

  int i = 0;
  for (int gi = 0; gi < G; ++gi) {
    for (int jj = 0; jj < n; ++jj, ++i) {
      const int s = i % ST;
      const int entry = list[jj], f = entry >> TILE_BITS;
      const int q0 = (jb + (entry & ((1 << TILE_BITS) - 1))) * BQ;
      const bf16* q_s = reinterpret_cast<const bf16*>(base + C::Q_OFF + (size_t)s * 2 * C::QT_BYTES);
      const bf16* do_s = q_s + BQ * D;
      const float* lse_t = lse_s + s * BQ;
      const float* delta_t = delta_s + s * BQ;
      const int* qseg_t = qseg_s + s * BQ;
      sm90::bar_wait(&full[s], (i / ST) & 1);

      float st[BQ / 2], dpt[BQ / 2];  // Sᵀ, dPᵀ: rows keys, columns queries
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      sm90::mma_fence();
      {
        const uint64_t dqb = sm90::desc(q_s, 16, 1024), ddob = sm90::desc(do_s, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::mma_ss<0, 0>(st, sm90::desc_add(dka, (kk / 4) * BK * 128 + (kk % 4) * 32),
                             sm90::desc_add(dqb, (kk / 4) * BQ * 128 + (kk % 4) * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::mma_ss<0, 0>(dpt, sm90::desc_add(dva, (kk / 4) * BK * 128 + (kk % 4) * 32),
                             sm90::desc_add(ddob, (kk / 4) * BQ * 128 + (kk % 4) * 32), kk > 0);
      }
      sm90::mma_commit();
      sm90::mma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // pᵀ = exp(s·scale − lse), dsᵀ = pᵀ (dpᵀ − delta), per query column
      uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float pv[2], dsv[2];
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int idx = 8 * kk + 2 * x + y;  // accumulator slot
            const int r = (idx >> 1) & 1, c = 8 * (idx >> 2) + 2 * t4 + (idx & 1), qp = q0 + c;
            bool ok = true;
            if (f & BOUND_MASK) ok = qp < S && row[r] < S && (!causal || qp >= row[r]);
            if (f & SEG_MASK) ok = ok && qseg_t[c] == ks[r];
            const float p = ok ? exp2f(st[idx] * c1 - lse_t[c] * LOG2E) : 0.f;
            pv[y] = p;
            dsv[y] = p * (dpt[idx] - delta_t[c]);
          }
          pf[kk][x] = pack(pv[0], pv[1]);
          dsf[kk][x] = pack(dsv[0], dsv[1]);
        }

      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::mma_fence();
      {
        // dO and Q MN-major for the products over queries (LBO: next 64
        // columns), from this warpgroup's first column on
        const uint64_t ddo_t = sm90::desc(do_s + (c0 / 64) * BQ * 64, BQ * 128, 1024);
        const uint64_t dq_t = sm90::desc(q_s + (c0 / 64) * BQ * 64, BQ * 128, 1024);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          sm90::mma_rs<1>(dv, pf[kk], sm90::desc_add(ddo_t, kk * 16 * 128), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          sm90::mma_rs<1>(dk, dsf[kk], sm90::desc_add(dq_t, kk * 16 * 128), 1);
      }
      sm90::mma_commit();
      sm90::mma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::fence_regs(pf);
      sm90::fence_regs(dsf);
      if (lane == 0) sm90::bar_arrive(&empty[s]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = row[r];
    if (kp >= S) continue;
    const int64_t off = (((int64_t)b * S + kp) * Hkv + kvh) * D + c0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      store_pair(dk_out + off + 8 * j + 2 * t4, dk[4 * j + 2 * r] * scale,
                     dk[4 * j + 2 * r + 1] * scale);
      store_pair(dv_out + off + 8 * j + 2 * t4, dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (query tile of 64 NC rows, head, batch row), laid out as
// the forward.  Q and dO of the tile stay resident; K and V of each live key
// tile stream through the ring.  Per tile pair and consumer warpgroup:
//   S = Q Kᵀ, dP = dO Vᵀ (both ss, K-major), issued together; p from S while
//   dP is still in flight; dS = p (dP − delta) rounded to bf16 into register
//   A fragments; dQ += dS K with K read MN-major (rs).
// ---------------------------------------------------------------------------

template <int D> struct Dq {
  static constexpr int NC = D == 256 ? 1 : 2, BQ = 64 * NC, BK = 64, ST = D == 256 ? 2 : 4;
  static constexpr int NT = WG_THREADS * (NC + 1), P = D / 64;
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr size_t DO_OFF = Q_BYTES, K_OFF = 2 * (size_t)Q_BYTES;
  static constexpr size_t KSEG_OFF = K_OFF + (size_t)ST * 2 * KV_BYTES;
  static constexpr size_t BAR_OFF = KSEG_OFF + ST * BK * sizeof(int);
  static constexpr size_t LIST_OFF = BAR_OFF + (1 + 2 * ST) * sizeof(uint64_t) + 16;
  static size_t smem(int n) { return 1024 + LIST_OFF + 2 * (size_t)n * sizeof(int); }
};

template <int D>
__global__ void __launch_bounds__(Dq<D>::NT, 1)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ qseg, const int* __restrict__ kseg,
                bf16* __restrict__ dq_out, int S, int H, int Hkv, float scale, int causal) {
  using C = Dq<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST, P = C::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(base);
  bf16* do_s = reinterpret_cast<bf16*>(base + C::DO_OFF);
  int* kseg_s = reinterpret_cast<int*>(base + C::KSEG_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);  // q + dO, full[ST], empty[ST]
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;
  int* n_live = reinterpret_cast<int*>(empty + ST);
  int* flags = reinterpret_cast<int*>(base + C::LIST_OFF);

  const int nqt = gridDim.y;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * BQ;  // heaviest causal tiles launch first
  const int h = blockIdx.x % H, b = blockIdx.x / H, kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_last = min(q0 + BQ, S) - 1;
  const int nk = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  int* list = flags + nk;

  key_tile_flags<BK, C::NT>(qseg, kseg, b, S, q0, q_last, nk, causal, flags, warp, lane);
  const int n = ring_setup<ST, C::NC>(bars, flags, list, nk, n_live, warp, lane);
  const int wgi = threadIdx.x / WG_THREADS;

  if (wgi == C::NC) {  // producer
    if constexpr (C::NC > 1) sm90::regs_dec<24>();
    if (warp % 4 != 0) return;
    if (lane == 0) {
      sm90::bar_arrive_tx(&bars[0], 2 * C::Q_BYTES);
      for (int p = 0; p < P; ++p) {
        sm90::tma_load_4d(q_s + p * BQ * 64, &tm_q, &bars[0], 64 * p, h, q0, b);
        sm90::tma_load_4d(do_s + p * BQ * 64, &tm_do, &bars[0], 64 * p, h, q0, b);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % ST;
      sm90::bar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      const int k0 = (list[i] & ((1 << TILE_BITS) - 1)) * BK;
      if (kseg)
        for (int r = lane; r < BK; r += 32)
          kseg_s[s * BK + r] = k0 + r < S ? kseg[(int64_t)b * S + k0 + r] : 0;
      if (lane == 0) {
        sm90::bar_arrive_tx(&full[s], 2 * C::KV_BYTES);
        bf16* k_s = reinterpret_cast<bf16*>(base + C::K_OFF + (size_t)s * 2 * C::KV_BYTES);
        bf16* v_s = k_s + BK * D;
        for (int p = 0; p < P; ++p) {
          sm90::tma_load_4d(k_s + p * BK * 64, &tm_k, &full[s], 64 * p, kvh, k0, b);
          sm90::tma_load_4d(v_s + p * BK * 64, &tm_v, &full[s], 64 * p, kvh, k0, b);
        }
      } else {
        sm90::bar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns query rows q0 + 64 wgi .. + 63
  if constexpr (C::NC > 1) sm90::regs_inc<240>();
  const int wl = warp % 4, g = lane / 4, t4 = lane % 4;
  const int row[2] = {q0 + 64 * wgi + 16 * wl + g, q0 + 64 * wgi + 16 * wl + g + 8};
  int qs[2] = {0, 0};
  float lse2[2], dlt[2];  // lse in the log2 domain, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < S;
    const int64_t at = ((int64_t)b * H + h) * S + row[r];
    lse2[r] = in ? lse[at] * LOG2E : 0.f;
    dlt[r] = in ? delta[at] : 0.f;
    if (qseg) qs[r] = in ? qseg[(int64_t)b * S + row[r]] : 0;
  }
  const float c1 = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // Q and dO K-major (this warpgroup's 64 rows)
  const uint64_t dqa = sm90::desc(q_s + 64 * wgi * 64, 16, 1024);
  const uint64_t doa = sm90::desc(do_s + 64 * wgi * 64, 16, 1024);
  sm90::bar_wait(&bars[0], 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    const int entry = list[i], f = entry >> TILE_BITS;
    const int k0 = (entry & ((1 << TILE_BITS) - 1)) * BK;
    const bf16* k_s = reinterpret_cast<const bf16*>(base + C::K_OFF + (size_t)s * 2 * C::KV_BYTES);
    const uint64_t dk = sm90::desc(k_s, 16, 1024);
    const uint64_t dv = sm90::desc(k_s + BK * D, 16, 1024);
    sm90::bar_wait(&full[s], (i / ST) & 1);

    float sc[BK / 2], dp[BK / 2];
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<0, 0>(sc, sm90::desc_add(dqa, (kk / 4) * BQ * 128 + (kk % 4) * 32),
                         sm90::desc_add(dk, (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
    sm90::mma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<0, 0>(dp, sm90::desc_add(doa, (kk / 4) * BQ * 128 + (kk % 4) * 32),
                         sm90::desc_add(dv, (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
    sm90::mma_commit();
    sm90::mma_wait<1>();  // S has landed; dP may still run
    sm90::fence_regs(sc);

    // p = exp(s·scale − lse), masked ones exactly 0
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      const int r = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * t4 + (x & 1), kp = k0 + c;
      bool ok = true;
      if (f & BOUND_MASK) ok = kp < S && (!causal || row[r] >= kp);
      if (f & SEG_MASK) ok = ok && qs[r] == kseg_s[s * BK + c];
      sc[x] = ok ? exp2f(sc[x] * c1 - lse2[r]) : 0.f;
    }
    sm90::mma_wait<0>();
    sm90::fence_regs(dp);

    // ds = p (dp − delta), rounded to bf16 as the A fragments of dQ += dS K
    uint32_t dsf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i0 = 8 * kk + 2 * x, r = x & 1;
        dsf[kk][x] = pack(sc[i0] * (dp[i0] - dlt[r]), sc[i0 + 1] * (dp[i0 + 1] - dlt[r]));
      }

    sm90::fence_regs(acc);
    sm90::mma_fence();
    {
      const uint64_t dkt = sm90::desc(k_s, BK * 128, 1024);  // K MN-major (LBO: next 64 columns)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::mma_rs<1>(acc, dsf[kk], sm90::desc_add(dkt, kk * 16 * 128), 1);
    }
    sm90::mma_commit();
    sm90::mma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(dsf);
    if (lane == 0) sm90::bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row[r];
    if (qp >= S) continue;
    bf16* dst = dq_out + (((int64_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(dst + 8 * j + 2 * t4, acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *qseg, *kseg;
  void *out, *out2;
  int B, S, H, Hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_fwd(const Args& a) {
  static bool ready = false;
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = allow_smem(kernel, Fwd<D>::smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + Fwd<D>::BQ - 1) / Fwd<D>::BQ, a.H, a.B);
  kernel<<<grid, Fwd<D>::NT, Fwd<D>::smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg), static_cast<float*>(a.out),
      static_cast<float*>(a.out2), a.S, a.H, a.Hkv, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a) {
  static bool ready = false;
  auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t err = allow_smem(kernel, Dq<D>::smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + Dq<D>::BQ - 1) / Dq<D>::BQ, a.H, a.B);
  kernel<<<grid, Dq<D>::NT, Dq<D>::smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<float*>(a.out), a.S, a.H, a.Hkv, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  static bool ready = false;
  auto kernel = flash_bwd_dkv_kernel<D>;
  cudaError_t err = allow_smem(kernel, Dkv<D>::smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + Dkv<D>::BK - 1) / Dkv<D>::BK, a.Hkv, a.B);
  kernel<<<grid, Dkv<D>::NT, Dkv<D>::smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<float*>(a.out), static_cast<float*>(a.out2), a.S,
      a.H, a.Hkv, a.scale, a.causal);
  return cudaGetLastError();
}

// The Hopper kernels take the opt-in maximum of dynamic shared memory once
// and launch with what the shape needs (the tile list grows with S).
constexpr size_t MAX_SMEM = 232448;

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int D>
cudaError_t launch_wg_fwd(const Args& a) {
  using C = wg::Fwd<D>;
  static bool ready = false;
  auto kernel = wg::flash_fwd_wg<D>;
  cudaError_t err = allow_smem(kernel, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v)) return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if (!sm90::encode_bf16_4d(&tq, a.q, D, a.H, a.S, a.B, C::BQ) ||
      !sm90::encode_bf16_4d(&tk, a.k, D, a.Hkv, a.S, a.B, C::BK) ||
      !sm90::encode_bf16_4d(&tv, a.v, D, a.Hkv, a.S, a.B, C::BK))
    return cudaErrorNotSupported;
  const dim3 grid(a.H * a.B, (a.S + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::NT, C::smem((a.S + C::BK - 1) / C::BK), a.stream>>>(
      tq, tk, tv, static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg),
      static_cast<wg::bf16*>(a.out), static_cast<float*>(a.out2), a.S, a.H, a.Hkv, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wg_dq(const Args& a) {
  using C = wg::Dq<D>;
  static bool ready = false;
  auto kernel = wg::flash_bwd_dq_wg<D>;
  cudaError_t err = allow_smem(kernel, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dout))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm90::encode_bf16_4d(&tq, a.q, D, a.H, a.S, a.B, C::BQ) ||
      !sm90::encode_bf16_4d(&tk, a.k, D, a.Hkv, a.S, a.B, C::BK) ||
      !sm90::encode_bf16_4d(&tv, a.v, D, a.Hkv, a.S, a.B, C::BK) ||
      !sm90::encode_bf16_4d(&tdo, a.dout, D, a.H, a.S, a.B, C::BQ))
    return cudaErrorNotSupported;
  const dim3 grid(a.H * a.B, (a.S + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::NT, C::smem((a.S + C::BK - 1) / C::BK), a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg),
      static_cast<wg::bf16*>(a.out), a.S, a.H, a.Hkv, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wg_dkv(const Args& a) {
  using C = wg::Dkv<D>;
  static bool ready = false;
  auto kernel = wg::flash_bwd_dkv_wg<D>;
  cudaError_t err = allow_smem(kernel, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dout))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm90::encode_bf16_4d(&tq, a.q, D, a.H, a.S, a.B, C::BQ) ||
      !sm90::encode_bf16_4d(&tk, a.k, D, a.Hkv, a.S, a.B, C::BK) ||
      !sm90::encode_bf16_4d(&tv, a.v, D, a.Hkv, a.S, a.B, C::BK) ||
      !sm90::encode_bf16_4d(&tdo, a.dout, D, a.H, a.S, a.B, C::BQ))
    return cudaErrorNotSupported;
  const dim3 grid(a.Hkv * a.B, (a.S + C::BK - 1) / C::BK);
  kernel<<<grid, C::NT, C::smem((a.S + C::BQ - 1) / C::BQ), a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg),
      static_cast<wg::bf16*>(a.out), static_cast<wg::bf16*>(a.out2), a.S, a.H, a.Hkv, a.scale,
      a.causal);
  return cudaGetLastError();
}

enum class Which { fwd, dq, dkv };

// f32 on the CUDA cores, bf16 on the tensor cores
template <int D>
cudaError_t launch(Which which, const Args& a, bool tensor_cores) {
  switch (which) {
    case Which::fwd: return tensor_cores ? launch_wg_fwd<D>(a) : launch_fwd<D>(a);
    case Which::dq: return tensor_cores ? launch_wg_dq<D>(a) : launch_dq<D>(a);
    default: return tensor_cores ? launch_wg_dkv<D>(a) : launch_dkv<D>(a);
  }
}

// dtype: 0 = float32, 1 = bfloat16; head dims 64, 128 and 256.
int dispatch(Which which, const Args& a, int D, int dtype) {
  if (a.B <= 0 || a.S <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((a.qseg == nullptr) != (a.kseg == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)launch<64>(which, a, dtype == 1);
  if (D == 128) return (int)launch<128>(which, a, dtype == 1);
  if (D == 256) return (int)launch<256>(which, a, dtype == 1);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out (B, S, H, D) in the input dtype; lse (B, H, S) f32.  qseg/kseg both
// null (no segment mask) or both (B, S) int32.
int ftc_flash_fwd(const void* q, const void* k, const void* v, const void* qseg,
                  const void* kseg, void* out, void* lse, int B, int S, int H, int Hkv, int D,
                  int causal, int dtype, float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, qseg, kseg, out, lse, B, S, H, Hkv,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(Which::fwd, a, D, dtype);
}

// dq (B, S, H, D) in the input dtype; lse and delta (B, H, S) f32.
int ftc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* qseg, const void* kseg,
                     void* dq, int B, int S, int H, int Hkv, int D, int causal, int dtype,
                     float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qseg, kseg, dq, nullptr, B, S, H, Hkv,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(Which::dq, a, D, dtype);
}

// dk, dv (B, S, Hkv, D) in the input dtype.
int ftc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* qseg, const void* kseg,
                      void* dk, void* dv, int B, int S, int H, int Hkv, int D, int causal,
                      int dtype, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qseg, kseg, dk, dv, B, S, H, Hkv,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(Which::dkv, a, D, dtype);
}

const char* ftc_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
