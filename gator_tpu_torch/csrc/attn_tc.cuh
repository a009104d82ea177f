// The two-pass softmax attention of one warp's 16 query rows on the tensor
// cores, shared by K3 (fused_attention.cu: one head per CTA) and K2's
// self-attention (lbf_stack.cu: both heads of a query tile per CTA, then
// L3 and the residual).
//
// Numerics, as the TPU kernels: scores and softmax in f32; the normalised
// probabilities rounded to the working type T before the PV product,
// which accumulates in f32. The products run on the tensor cores
// (mma.cuh): bf16 m16n8k16, or in f32 the 3xTF32 split, which keeps f32
// accuracy (TF32 is never used alone).
//
// Design. A warp owns 16 query rows, whose q fragments stay in registers.
// The keys' K and V rows are staged in shared memory in their own dtype
// with cp.async, in chunks of `kc` keys (a multiple of the 64-key tile;
// one chunk, staged once, whenever the keys fit the CTA's share of the
// SM). Two passes over 64-key tiles: pass 1 takes each row's max and sum
// online; pass 2 recomputes the scores with the same mma chain, forms
// p = T(exp(s - max) / sum) and runs PV, so the probabilities are rounded
// normalised and nothing of the [Nq, Nk] score tile is stored. The
// exponentials are exp2 of scores scaled by log2(e) (the caller's
// `finish`), the division a product with the row's reciprocal sum. The
// score accumulators become PV's A operand in registers (bf16), or by
// shuffles (TF32, whose A layout differs); K and V fragments come from
// ldmatrix (bf16) or padded, conflict-free shared-memory rows (f32).
#pragma once

#include "mma.cuh"

namespace gator {
namespace attn {

constexpr int KT = 64;  // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

// shared memory of one CTA, so that two fit on an H100 SM (228 KB, 1 KB
// of it reserved per CTA)
constexpr int SMEM_PER_CTA = 113 * 1024;

// padded lengths, in elements, of staged K and V rows of W elements (one
// head's D in K3, both heads' 64 in K2): conflict-free fragment loads
// (f32) and ldmatrix rows (bf16)
template <typename T, int W>
struct Pad {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int LK = W + (F32 ? 4 : 8);
  static constexpr int LV = W + 8;
  static constexpr int KEY_BYTES = (LK + LV) * (int)sizeof(T);
  static_assert(SMEM_PER_CTA / KEY_BYTES >= KT, "one key tile must fit");
};

// keys per staged K/V chunk: every key (rounded up to KT) when they fit in
// SMEM_PER_CTA, else the largest multiple of KT that does
template <typename T, int W>
int chunk_keys(int nk) {
  const int whole = (nk + KT - 1) / KT * KT;
  const int fit = SMEM_PER_CTA / Pad<T, W>::KEY_BYTES / KT * KT;
  return whole < fit ? whole : fit;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage keys [key0, key0 + n) of K (and V), rows of W elements k_n (v_n)
// apart in global memory, into shared memory with cp.async (uncommitted);
// rows n .. the next multiple of KT are zeroed, and so are K's pad columns
// where a bf16 mma step (16) is deeper than W.
template <typename T, int W>
__device__ __forceinline__ void stage_kv(T* Ks, T* Vs, const T* kb,
                                         const T* vb, long long k_n,
                                         long long v_n, int key0, int n,
                                         bool with_v) {
  using L = Pad<T, W>;
  tc::stage(Ks, L::LK, kb + key0 * k_n, (int)k_n, n, W);
  if (with_v) tc::stage(Vs, L::LV, vb + key0 * v_n, (int)v_n, n, W);
  const int end = round_up(n, KT);
  const T zero = Num<T>::from_float(0.0f);
  for (int i = threadIdx.x; i < (end - n) * W; i += blockDim.x) {
    const int r = n + i / W, c = i % W;
    Ks[r * L::LK + c] = zero;
    if (with_v) Vs[r * L::LV + c] = zero;
  }
  if (!L::F32 && W < 16)
    for (int i = threadIdx.x; i < end * (16 - W); i += blockDim.x)
      Ks[i / (16 - W) * L::LK + W + i % (16 - W)] = zero;
}

template <typename T, int D>
__host__ __device__ constexpr int ksteps() {  // mma steps over a head width
  return (D + tc::Mma<T>::KS - 1) / tc::Mma<T>::KS;
}

template <typename T, int D>
using QFrags = typename tc::Mma<T>::A[ksteps<T, D>()];

// the 64-key tile's scores of this warp's rows against one head's keys
// (Ks: the tile's first row at the head's first column, rows LK apart):
// s[j][i] is key 8j + 2t + (i & 1), row g + 8 (i >> 1)
template <typename T, int D, int LK>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const QFrags<T, D>& qf, const T* Ks) {
  using P = tc::Mma<T>;
  constexpr int KSTEPS = ksteps<T, D>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      typename P::B b;
      if constexpr (sizeof(T) == 4) {
        const float* kr = reinterpret_cast<const float*>(Ks) +
                          (8 * j + g) * LK + ks * 8 + t;
        tc::split_tf32(kr[0], b.hi[0], b.lo[0]);
        tc::split_tf32(kr[4], b.hi[1], b.lo[1]);
      } else {
        tc::ldsm_x2(b.r, Ks + (8 * j + (lane & 7)) * LK + ks * 16 +
                             ((lane >> 3) & 1) * 8);
      }
      P::mma(s[j], qf[ks], b);
    }
  }
}

// o = T(softmax(q k^T)) v for this warp's 16 rows and one head of width D,
// over nk keys staged W wide (`Ks`, `Vs`: the staged buffers at the head's
// first column). Called by every thread of the CTA (it syncs the block);
// `active` is false for a warp with no rows (it still stages).
//   stage(key0, n, with_v)  starts the cp.async copies of keys [key0,
//                           key0 + n) into the buffers (`stage_kv`);
//   finish(s, key0)         turns a tile's raw scores into base-2 logits,
//                           -inf past the last key.
// o[jn][i] is column 8 jn + 2t + (i & 1) of row g + 8 (i >> 1), f32.
template <typename T, int D, int W, class Stage, class Finish>
__device__ __forceinline__ void two_pass(float (&o)[D / 8][4],
                                         const QFrags<T, D>& qf, const T* Ks,
                                         const T* Vs, int nk, int kc,
                                         bool active, Stage stage,
                                         Finish finish) {
  using P = tc::Mma<T>;
  using L = Pad<T, W>;
  constexpr int NO = D / 8;  // output column tiles
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nchunks = (nk + kc - 1) / kc;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  // pass 1: row max and sum, online
  for (int c = 0; c < nchunks; ++c) {
    const int key0 = c * kc, n = min(kc, nk - key0);
    __syncthreads();
    stage(key0, n, nchunks == 1);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int kt = 0; kt < n; kt += KT) {
      float s[8][4];
      scores<T, D, L::LK>(s, qf, Ks + kt * L::LK);
      finish(s, key0 + kt);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float tm = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tm = fmaxf(tm, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
        const float mn = fmaxf(mx[rr], quad_max(tm));
        float acc = l[rr] * exp2f(mx[rr] - mn);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc += exp2f(s[j][2 * rr] - mn) + exp2f(s[j][2 * rr + 1] - mn);
        l[rr] = acc;
        mx[rr] = mn;
      }
    }
  }
  const float inv[2] = {1.0f / quad_sum(l[0]), 1.0f / quad_sum(l[1])};

  // pass 2: p = T(exp(s - max) / sum), o = p v
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.0f;
  for (int c = 0; c < nchunks; ++c) {
    const int key0 = c * kc, n = min(kc, nk - key0);
    if (nchunks > 1) {
      __syncthreads();
      stage(key0, n, true);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    for (int kt = 0; kt < n; kt += KT) {
      float s[8][4];
      scores<T, D, L::LK>(s, qf, Ks + kt * L::LK);
      finish(s, key0 + kt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[j][i] = rnd<T>(exp2f(s[j][i] - mx[i >> 1]) * inv[i >> 1]);
      const T* vt = Vs + kt * L::LV;
      if constexpr (L::F32) {
        const int src0 = (lane & ~3) | (t >> 1), src1 = src0 + 2;
        const bool odd = t & 1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[i] = __shfl_sync(0xffffffffu, s[j][i], src0);
            x[4 + i] = __shfl_sync(0xffffffffu, s[j][i], src1);
          }
          typename P::A a;
          tc::split_tf32(odd ? x[1] : x[0], a.hi[0], a.lo[0]);
          tc::split_tf32(odd ? x[3] : x[2], a.hi[1], a.lo[1]);
          tc::split_tf32(odd ? x[5] : x[4], a.hi[2], a.lo[2]);
          tc::split_tf32(odd ? x[7] : x[6], a.hi[3], a.lo[3]);
          const float* vr = reinterpret_cast<const float*>(vt) +
                            (8 * j + t) * L::LV + g;
#pragma unroll
          for (int jn = 0; jn < NO; ++jn) {
            typename P::B bv;
            tc::split_tf32(vr[8 * jn], bv.hi[0], bv.lo[0]);
            tc::split_tf32(vr[4 * L::LV + 8 * jn], bv.hi[1], bv.lo[1]);
            P::mma(o[jn], a, bv);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          typename P::A a;
          a.r[0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          a.r[1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          a.r[2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          a.r[3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int jn = 0; jn < NO; ++jn) {
            typename P::B bv;
            tc::ldsm_x2_trans(bv.r,
                              vt + (16 * kk + (lane & 15)) * L::LV + 8 * jn);
            P::mma(o[jn], a, bv);
          }
        }
      }
    }
  }
}

}  // namespace attn
}  // namespace gator
