// Flash attention for training on Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of
// finetune_controller_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_tc / flash_fwd_kernel         <- _fwd_kernel (pallas_call in _flash_forward)
//   flash_bwd_dq_tc / flash_bwd_dq_kernel   <- _bwd_dq_kernel (first in _flash_backward)
//   flash_bwd_dkv_tc / flash_bwd_dkv_kernel <- _bwd_dkv_kernel (second in _flash_backward)
// (the bf16 / the f32 kernel of each, for head dims 64 and 128).
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
// are ~30x below the operations even at the tensor-core rate.
//
// Two paths, chosen by dtype:
//   * bf16 (the training path) runs its products on the tensor cores with
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), namespace tc below;
//   * f32 runs them as FMAs on the CUDA cores (the card's 67 TFLOP/s f32
//     rate), so f32 results differ from the plain version only in summation
//     order.
// wgmma, TMA loads, a producer warp and software pipelining are later work.
//
// Design, both paths:
//   * one block per (query tile, query head, batch row) for the forward and
//     dQ, one per (key tile, KV head, batch row) for dK/dV; the sequential
//     grid axis of the TPU kernels becomes a loop inside the block;
//   * the loops stop at the causal frontier: the forward and dQ walk key
//     tiles up to the tile's last query, dK/dV walk query tiles from the tile
//     holding its first key;
//   * dK/dV loops over every query head of its KV head's group inside the
//     block, so the GQA sum needs no atomics and is deterministic;
//   * ragged tails are masked in the kernel: rows at or past S read as zero
//     and are never written (the TPU path pads because its DMAs clamp).
// The f32 path stages tiles in shared memory, rows padded by 4 floats
// so the 16-byte reads of the 8 threads that share a row group hit distinct
// banks; each thread owns RM rows x RN columns of a score tile (rows
// rg + RG*i, columns cg + 8*j) and RM rows x D/8 columns of an accumulator
// (dims 4*cg + 32*k .. +3), and a row's 8 owners are 8 neighbouring lanes.
// The tensor-core path's layout is described above namespace tc.
// Numerics follow the Pallas kernels: f32 scores times the scale, f32 exp
// (the TPU default for bf16 inputs is a bf16 exp), p rounded to the value
// dtype before the PV and dV products, ds rounded to the key/query dtype
// before the dQ and dK products (both only on the bf16 path: f32 rounds to
// itself), f32 accumulation, the scale applied to dQ and dK once at the end.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// ops/kernels/flash_attention.py; each entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// bf16 on the tensor cores: mma.sync.m16n8k16 (bf16 x bf16 -> f32)
//
// Each warp owns 16 rows of a tile (queries for the forward and dQ, keys for
// dK/dV) and keeps its score tile and accumulators as mma fragments: a thread
// holds rows g = lane / 4 and g + 8, columns 2t and 2t + 1 (t = lane % 4) of
// every 8-column slice.  A row's owners are the 4 lanes of a quad, so row max
// and sum are two shuffles.  A score/probability fragment converts in
// registers into the A operand of the next product (FlashAttention-2's
// layout trick), rounded to bf16 as the Pallas kernels round p and ds.
// Tiles stay bf16 in shared memory, rows padded by 8 elements so the 32-bit
// fragment reads of a warp hit 32 distinct banks; operands that a product
// needs along the other axis are staged transposed once per tile.
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NT = 128;  // 4 warps

__device__ __forceinline__ uint32_t ld32(const bf16* base, int ld, int row, int col) {
  return *reinterpret_cast<const uint32_t*>(base + row * ld + col);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row-major fragment) * b (16x8, column fragment)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* m, int ld, int r0, int c0,
                                       int g, int t) {
  a[0] = ld32(m, ld, r0 + g, c0 + 2 * t);
  a[1] = ld32(m, ld, r0 + g + 8, c0 + 2 * t);
  a[2] = ld32(m, ld, r0 + g, c0 + 8 + 2 * t);
  a[3] = ld32(m, ld, r0 + g + 8, c0 + 8 + 2 * t);
}

// The A fragment of columns [16 kk, 16 kk + 16) of a 16-row score fragment.
template <int N>
__device__ __forceinline__ void frag_from_scores(uint32_t (&a)[4], const float (&s)[N][4], int kk) {
  a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// acc[i][j] += sum_k A[rows of the warp][k] * B[8i + j'][k] over k < D: A's
// fragments from row-major `a_s` (rows r0..), B from row-major `b_s` (its
// rows are the output columns).
template <int D, int NC>
__device__ __forceinline__ void mma_nt(float (&acc)[NC / 8][4], const bf16* a_s, const bf16* b_s,
                                       int ld, int r0, int g, int t) {
#pragma unroll
  for (int k = 0; k < D; k += 16) {
    uint32_t a[4];
    frag_a(a, a_s, ld, r0, k, g, t);
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
      mma(acc[j], a, ld32(b_s, ld, 8 * j + g, k + 2 * t), ld32(b_s, ld, 8 * j + g, k + 8 + 2 * t));
  }
}

// acc[n][.] += P (16 x NK, from score fragments) * M (NK x D), with M given
// transposed (`mt_s`, D rows of NK + 8).
template <int D, int NK>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4], const float (&p)[NK / 8][4],
                                       const bf16* mt_s, int g, int t) {
  constexpr int LDT = NK + 8;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    frag_from_scores<NK / 8>(a, p, kk);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      mma(acc[n], a, ld32(mt_s, LDT, 8 * n + g, 16 * kk + 2 * t),
          ld32(mt_s, LDT, 8 * n + g, 16 * kk + 8 + 2 * t));
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + ROWS) of one head's slice into a bf16 tile with leading
// dimension `ld` (rows at or past S read as zero).
template <int D, int ROWS>
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src, int row0, int S,
                                      int64_t stride) {
  constexpr int VPR = D / 8;
  for (int e = threadIdx.x; e < ROWS * VPR; e += NT) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) v = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// The same rows transposed: dst[c][r] with leading dimension ROWS + 8.
template <int D, int ROWS>
__device__ __forceinline__ void stage_t(bf16* dst, const bf16* src, int row0, int S,
                                        int64_t stride) {
  constexpr int LDT = ROWS + 8;
  for (int e = threadIdx.x; e < ROWS * (D / 8); e += NT) {
    const int r = e % ROWS, c = (e / ROWS) * 8;  // neighbouring threads: neighbouring rows
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) v = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * stride + c);
    const bf16* x = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * LDT + r] = x[i];
  }
}

__device__ __forceinline__ void store_pair(bf16* out, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(lo, hi);
}

template <int D> struct Fwd {
  static constexpr int BQ = 64, BK = 64, LD = D + 8;
  static constexpr size_t smem =
      ((size_t)(BQ + BK) * LD + (size_t)D * (BK + 8)) * sizeof(bf16) + (BQ + BK) * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const int* __restrict__ qseg, const int* __restrict__ kseg, bf16* __restrict__ out,
             float* __restrict__ lse, int S, int H, int Hkv, float scale, int causal) {
  using C = Fwd<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BQ * LD;
  bf16* vt_s = k_s + BK * LD;
  int* qseg_s = reinterpret_cast<int*>(vt_s + D * (BK + 8));
  int* kseg_s = qseg_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, r0 = (threadIdx.x / 32) * 16;
  const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
  const int64_t qoff = ((int64_t)b * S * H + h) * D, koff = ((int64_t)b * S * Hkv + kvh) * D;

  stage<D, BQ>(q_s, LD, q + qoff, q0, S, qstride);
  if (qseg) load_segments(qseg_s, qseg, b, q0, BQ, S, NT);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<D, BK>(k_s, LD, k + koff, k0, S, kstride);
    stage_t<D, BK>(vt_s, v + koff, k0, S, kstride);
    if (qseg) load_segments(kseg_s, kseg, b, k0, BK, S, NT);
    __syncthreads();

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_nt<D, BK>(s, q_s, k_s, LD, r0, g, t);

    float mx[2] = {NEG_INF, NEG_INF};
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = r0 + g + 8 * (e >> 1), qp = q0 + rl;
        const int cl = 8 * j + 2 * t + (e & 1), kp = k0 + cl;
        const bool ok = kp < S && (!causal || qp >= kp) && (!qseg || qseg_s[rl] == kseg_s[cl]);
        live |= (unsigned)ok << (4 * j + e);
        s[j][e] = ok ? s[j][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ((live >> (4 * j + e)) & 1u) ? expf(s[j][e] - m[e >> 1]) : 0.f;
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    mma_pv<D, BK>(o, s, vt_s, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + r0 + g + 8 * r;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[r], L_FLOOR);
    bf16* dst = out + qoff + (int64_t)qp * qstride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store_pair(dst + 8 * n + 2 * t, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (t == 0) lse[((int64_t)b * H + h) * S + qp] = m[r] + logf(fmaxf(l[r], L_FLOOR));
  }
}

template <int D> struct Dq {
  static constexpr int BQ = 64, BK = 64, LD = D + 8;
  static constexpr size_t smem =
      ((size_t)(2 * BQ + 2 * BK) * LD + (size_t)D * (BK + 8)) * sizeof(bf16) +
      (BQ + BK) * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ qseg,
                const int* __restrict__ kseg, bf16* __restrict__ dq, int S, int H, int Hkv,
                float scale, int causal) {
  using C = Dq<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BQ * LD;
  bf16* k_s = do_s + BQ * LD;
  bf16* v_s = k_s + BK * LD;
  bf16* kt_s = v_s + BK * LD;
  int* qseg_s = reinterpret_cast<int*>(kt_s + D * (BK + 8));
  int* kseg_s = qseg_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, r0 = (threadIdx.x / 32) * 16;
  const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
  const int64_t qoff = ((int64_t)b * S * H + h) * D, koff = ((int64_t)b * S * Hkv + kvh) * D;
  const int64_t row_stats = ((int64_t)b * H + h) * S;

  stage<D, BQ>(q_s, LD, q + qoff, q0, S, qstride);
  stage<D, BQ>(do_s, LD, dout + qoff, q0, S, qstride);
  if (qseg) load_segments(qseg_s, qseg, b, q0, BQ, S, NT);

  float lse_r[2], delta_r[2], acc[D / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + r0 + g + 8 * r;
    lse_r[r] = qp < S ? lse[row_stats + qp] : 0.f;
    delta_r[r] = qp < S ? delta[row_stats + qp] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<D, BK>(k_s, LD, k + koff, k0, S, kstride);
    stage<D, BK>(v_s, LD, v + koff, k0, S, kstride);
    stage_t<D, BK>(kt_s, k + koff, k0, S, kstride);
    if (qseg) load_segments(kseg_s, kseg, b, k0, BK, S, NT);
    __syncthreads();

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_nt<D, BK>(s, q_s, k_s, LD, r0, g, t);
    mma_nt<D, BK>(dp, do_s, v_s, LD, r0, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, rl = r0 + g + 8 * r, qp = q0 + rl;
        const int cl = 8 * j + 2 * t + (e & 1), kp = k0 + cl;
        const bool ok = kp < S && (!causal || qp >= kp) && (!qseg || qseg_s[rl] == kseg_s[cl]);
        const float p = ok ? expf(s[j][e] * scale - lse_r[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[r]);  // ds
      }
    mma_pv<D, BK>(acc, s, kt_s, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + r0 + g + 8 * r;
    if (qp >= S) continue;
    bf16* dst = dq + qoff + (int64_t)qp * qstride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store_pair(dst + 8 * n + 2 * t, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int D> struct Dkv {
  static constexpr int BK = 64, BQ = 32, LD = D + 8;
  static constexpr size_t smem =
      ((size_t)(2 * BK + 2 * BQ) * LD + (size_t)2 * D * (BQ + 8)) * sizeof(bf16) +
      2 * BQ * sizeof(float) + (BQ + BK) * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ qseg, const int* __restrict__ kseg, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int H, int Hkv, float scale, int causal) {
  using C = Dkv<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NJ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BK * LD;
  bf16* q_s = v_s + BK * LD;
  bf16* do_s = q_s + BQ * LD;
  bf16* qt_s = do_s + BQ * LD;
  bf16* dot_s = qt_s + D * (BQ + 8);
  float* lse_s = reinterpret_cast<float*>(dot_s + D * (BQ + 8));
  float* delta_s = lse_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ);
  int* kseg_s = qseg_s + BQ;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, r0 = (threadIdx.x / 32) * 16;
  const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
  const int64_t koff = ((int64_t)b * S * Hkv + kvh) * D;

  stage<D, BK>(k_s, LD, k + koff, k0, S, kstride);
  stage<D, BK>(v_s, LD, v + koff, k0, S, kstride);
  if (qseg) load_segments(kseg_s, kseg, b, k0, BK, S, NT);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const int64_t qoff = ((int64_t)b * S * H + h) * D;
    const int64_t row_stats = ((int64_t)b * H + h) * S;
    for (int q0 = q_begin; q0 < S; q0 += BQ) {
      __syncthreads();
      stage<D, BQ>(q_s, LD, q + qoff, q0, S, qstride);
      stage<D, BQ>(do_s, LD, dout + qoff, q0, S, qstride);
      stage_t<D, BQ>(qt_s, q + qoff, q0, S, qstride);
      stage_t<D, BQ>(dot_s, dout + qoff, q0, S, qstride);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse[row_stats + q0 + r] : 0.f;
        delta_s[r] = in ? delta[row_stats + q0 + r] : 0.f;
      }
      if (qseg) load_segments(qseg_s, qseg, b, q0, BQ, S, NT);
      __syncthreads();

      // transposed tiles: rows are the warp's keys, columns the queries
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_nt<D, BQ>(s, k_s, q_s, LD, r0, g, t);
      mma_nt<D, BQ>(dp, v_s, do_s, LD, r0, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = r0 + g + 8 * (e >> 1), kp = k0 + rl;
          const int cl = 8 * j + 2 * t + (e & 1), qp = q0 + cl;
          const bool ok = qp < S && kp < S && (!causal || qp >= kp) &&
                          (!qseg || qseg_s[cl] == kseg_s[rl]);
          const float p = ok ? expf(s[j][e] * scale - lse_s[cl]) : 0.f;
          dp[j][e] = p * (dp[j][e] - delta_s[cl]);  // ds
          s[j][e] = p;
        }
      mma_pv<D, BQ>(dv_acc, s, dot_s, g, t);
      mma_pv<D, BQ>(dk_acc, dp, qt_s, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + r0 + g + 8 * r;
    if (kp >= S) continue;
    bf16* dk_row = dk + koff + (int64_t)kp * kstride;
    bf16* dv_row = dv + koff + (int64_t)kp * kstride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store_pair(dk_row + 8 * n + 2 * t, dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      store_pair(dv_row + 8 * n + 2 * t, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

}  // namespace tc

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

template <int D>
cudaError_t launch_tc_fwd(const Args& a) {
  using C = tc::Fwd<D>;
  static bool ready = false;
  auto kernel = tc::flash_fwd_tc<D>;
  cudaError_t err = allow_smem(kernel, C::smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + C::BQ - 1) / C::BQ, a.H, a.B);
  kernel<<<grid, tc::NT, C::smem, a.stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<tc::bf16*>(a.out),
      static_cast<float*>(a.out2), a.S, a.H, a.Hkv, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc_dq(const Args& a) {
  using C = tc::Dq<D>;
  static bool ready = false;
  auto kernel = tc::flash_bwd_dq_tc<D>;
  cudaError_t err = allow_smem(kernel, C::smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + C::BQ - 1) / C::BQ, a.H, a.B);
  kernel<<<grid, tc::NT, C::smem, a.stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<const tc::bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg),
      static_cast<tc::bf16*>(a.out), a.S, a.H, a.Hkv, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc_dkv(const Args& a) {
  using C = tc::Dkv<D>;
  static bool ready = false;
  auto kernel = tc::flash_bwd_dkv_tc<D>;
  cudaError_t err = allow_smem(kernel, C::smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + C::BK - 1) / C::BK, a.Hkv, a.B);
  kernel<<<grid, tc::NT, C::smem, a.stream>>>(
      static_cast<const tc::bf16*>(a.q), static_cast<const tc::bf16*>(a.k),
      static_cast<const tc::bf16*>(a.v), static_cast<const tc::bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg),
      static_cast<tc::bf16*>(a.out), static_cast<tc::bf16*>(a.out2), a.S, a.H, a.Hkv,
      a.scale, a.causal);
  return cudaGetLastError();
}

enum class Which { fwd, dq, dkv };

// f32 on the CUDA cores, bf16 on the tensor cores
template <int D>
cudaError_t launch(Which which, const Args& a, bool tensor_cores) {
  switch (which) {
    case Which::fwd: return tensor_cores ? launch_tc_fwd<D>(a) : launch_fwd<D>(a);
    case Which::dq: return tensor_cores ? launch_tc_dq<D>(a) : launch_dq<D>(a);
    default: return tensor_cores ? launch_tc_dkv<D>(a) : launch_dkv<D>(a);
  }
}

// dtype: 0 = float32, 1 = bfloat16; head dims 64 and 128.
int dispatch(Which which, const Args& a, int D, int dtype) {
  if (a.B <= 0 || a.S <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((a.qseg == nullptr) != (a.kseg == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)launch<64>(which, a, dtype == 1);
  if (D == 128) return (int)launch<128>(which, a, dtype == 1);
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
