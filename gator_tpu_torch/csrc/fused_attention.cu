// K3: fused attention, softmax(q k^T * scale + bias) v, with no probability
// tensor in device memory.
//
// Replaces gator_tpu/nn/pallas_attention.py:142 `fused_attention` (kernels
// `_kernel:31` and `_kernel_bias:49`, pallas_calls `:84` and `:94`).
// q [B, Nq, H, D], k and v [B, Nk, H, D] in the caller's strides (the last
// dimension contiguous, rows 16-byte aligned), an optional f32 bias
// [H, Nq, Nk] shared by every sample; out [B, Nq, H, D] contiguous, in q's
// dtype. On the model's path this is the MDR vertex self-attention of the
// module form (eval): Nq = Nk = 431, H = 2, D = 32, no bias.
//
// Numerics, as the TPU kernel: scores and softmax in f32; the normalised
// probabilities rounded to v's dtype before the PV product, which
// accumulates in f32. The products run on the tensor cores (mma.cuh): bf16
// m16n8k16, or in f32 the 3xTF32 split, which keeps f32 accuracy (TF32 is
// never used alone).
//
// Design. One CTA of eight warps per (128-query tile, head, sample) (four
// warps measured 10 % slower on the H100); each warp owns 16 query rows,
// whose q fragments stay in registers. The (sample, head)'s K and V are
// staged in shared memory in their own dtype with cp.async, in chunks of
// `kc` keys sized so that two CTAs fit on an SM (one chunk, staged once,
// whenever the keys fit: bf16 at Nk = 431; f32 there takes two). Two
// passes over 64-key tiles, as csrc/lbf_layer.cuh does for K2-layer:
// pass 1 takes each row's max and sum online; pass 2 recomputes the
// scores with the same mma chain, forms p = T(exp(s - max) / sum) and runs
// PV, so the probabilities are rounded normalised, where the TPU kernel
// rounds, and nothing of the [Nq, Nk] score tile is stored. The
// exponentials are exp2 of scores scaled by log2(e), the division a
// product with the row's reciprocal sum.
// The score accumulators become PV's A operand in registers (bf16), or by
// shuffles (TF32, whose A layout differs); K and V fragments come from
// ldmatrix (bf16) or padded, conflict-free shared-memory rows (f32).
//
// What bounds it on the H100. At the eval shape (B = 512) the work is
// 2 * 512 * 2 * 431 * 431 * 32 = 12.2 GFMA, twice that with pass 1's
// scores, against 226 MB of q, k, v and out (0.068 ms at 3.35 TB/s): on
// the tensor cores (bf16 0.05 ms for the 24 GFMA at 989 TFLOP/s) the bytes
// bound it; in f32 the three TF32 products and the splits (0.30 ms at
// 495 TFLOP/s for the products alone), and in both the two exponentials
// per score.
#include "mma.cuh"

namespace gator {
namespace attn {

constexpr int NW = 8;         // warps per CTA, 16 query rows each
constexpr int KT = 64;        // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

struct Shape {
  int nq, nk, h, kc;
  long long q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h;
};

// shared memory of one CTA, so that two fit on an H100 SM (228 KB, 1 KB
// of it reserved per CTA)
constexpr int SMEM_PER_CTA = 113 * 1024;

// padded row lengths of staged K and V, in elements: conflict-free
// fragment loads (f32) and ldmatrix rows (bf16)
template <typename T, int D>
struct Pad {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int LK = D + (F32 ? 4 : 8);
  static constexpr int LV = D + 8;
  static constexpr int KEY_BYTES = (LK + LV) * (int)sizeof(T);
  static_assert(SMEM_PER_CTA / KEY_BYTES >= KT, "one key tile must fit");
};

// keys per staged K/V chunk: every key (rounded up to KT) when they fit in
// SMEM_PER_CTA, else the largest multiple of KT that does
template <typename T, int D>
int chunk_keys(int nk) {
  const int whole = (nk + KT - 1) / KT * KT;
  const int fit = SMEM_PER_CTA / Pad<T, D>::KEY_BYTES / KT * KT;
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

// Stage keys [key0, key0 + n) of K (and V) into shared memory; rows n ..
// the next multiple of KT are zeroed, and so are K's pad columns where a
// bf16 mma step (16) is deeper than D.
template <typename T, int D>
__device__ __forceinline__ void stage_kv(T* Ks, T* Vs, const T* kb,
                                         const T* vb, const Shape& sh,
                                         int key0, int n, bool with_v) {
  using L = Pad<T, D>;
  tc::stage(Ks, L::LK, kb + key0 * sh.k_n, (int)sh.k_n, n, D);
  if (with_v) tc::stage(Vs, L::LV, vb + key0 * sh.v_n, (int)sh.v_n, n, D);
  const int end = round_up(n, KT);
  const T zero = Num<T>::from_float(0.0f);
  for (int i = threadIdx.x; i < (end - n) * D; i += blockDim.x) {
    const int r = n + i / D, c = i % D;
    Ks[r * L::LK + c] = zero;
    if (with_v) Vs[r * L::LV + c] = zero;
  }
  if (!L::F32 && D < 16)
    for (int i = threadIdx.x; i < end * (16 - D); i += blockDim.x)
      Ks[i / (16 - D) * L::LK + D + i % (16 - D)] = zero;
}

// the 64-key tile's scores of this warp's rows: s[j][i] is key 8j + 2t +
// (i & 1), row g + 8 (i >> 1)
template <typename T, int D>
__host__ __device__ constexpr int ksteps() {  // mma steps over a head width
  return (D + tc::Mma<T>::KS - 1) / tc::Mma<T>::KS;
}

template <typename T, int D>
__device__ __forceinline__ void scores(
    float (&s)[8][4], const typename tc::Mma<T>::A (&qf)[ksteps<T, D>()],
    const T* Ks) {
  using P = tc::Mma<T>;
  using L = Pad<T, D>;
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
      if constexpr (L::F32) {
        const float* kr = reinterpret_cast<const float*>(Ks) +
                          (8 * j + g) * L::LK + ks * 8 + t;
        tc::split_tf32(kr[0], b.hi[0], b.lo[0]);
        tc::split_tf32(kr[4], b.hi[1], b.lo[1]);
      } else {
        tc::ldsm_x2(b.r, Ks + (8 * j + (lane & 7)) * L::LK + ks * 16 +
                             ((lane >> 3) & 1) * 8);
      }
      P::mma(s[j], qf[ks], b);
    }
  }
}

// two CTAs per SM at every head width: at most 128 registers a thread
// (f32 at D = 64 takes 174 without the cap)
template <typename T, int D>
__global__ void __launch_bounds__(32 * NW, 2)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, Shape sh, float scale) {
  static_assert(D % 8 == 0, "head width");
  using P = tc::Mma<T>;
  using L = Pad<T, D>;
  constexpr int KSTEPS = ksteps<T, D>();
  constexpr int NO = D / 8;  // output column tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + sh.kc * L::LK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int m0 = blockIdx.x * 16 * NW + (threadIdx.x >> 5) * 16;
  const bool active = m0 < sh.nq;
  const int nk = sh.nk;
  const T* qb = q + b * sh.q_b + h * sh.q_h + (long long)m0 * sh.q_n;
  const T* kb = k + b * sh.k_b + h * sh.k_h;
  const T* vb = v + b * sh.v_b + h * sh.v_h;
  const float* bh = bias == nullptr ? nullptr : bias + (size_t)h * sh.nq * nk;
  const int rows[2] = {m0 + g, m0 + g + 8};

  typename P::A qf[KSTEPS];
  {
    const int nr = sh.nq - m0;
    auto qa = [&](int m, int d) {
      return m < nr && d < D ? ld(qb + m * sh.q_n + d) : 0.0f;
    };
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) qf[ks] = P::load_a(qa, 0, ks * P::KS);
  }

  // the scores in base 2, s = (acc * scale + bias) * log2(e), so that
  // exp2(s - max) is the softmax's exp; -inf past the last key
  const float sl = scale * LOG2E;
  auto finish = [&](float (&s)[8][4], int key0) {
    if (bh != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + 8 * j + 2 * t + (i & 1);
          const int row = rows[i >> 1];
          const float bv =
              row < sh.nq && key < nk ? bh[(size_t)row * nk + key] : 0.0f;
          s[j][i] = (s[j][i] * scale + bv) * LOG2E;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] *= sl;
    }
    if (key0 + KT > nk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (key0 + 8 * j + 2 * t + (i & 1) >= nk) s[j][i] = -CUDART_INF_F;
    }
  };

  const int nchunks = (nk + sh.kc - 1) / sh.kc;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  // pass 1: row max and sum, online
  for (int c = 0; c < nchunks; ++c) {
    const int key0 = c * sh.kc, n = min(sh.kc, nk - key0);
    __syncthreads();
    stage_kv<T, D>(Ks, Vs, kb, vb, sh, key0, n, nchunks == 1);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int kt = 0; kt < n; kt += KT) {
      float s[8][4];
      scores<T, D>(s, qf, Ks + kt * L::LK);
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

  // pass 2: p = T(exp(s - max) / sum), out = p v
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.0f;
  for (int c = 0; c < nchunks; ++c) {
    const int key0 = c * sh.kc, n = min(sh.kc, nk - key0);
    if (nchunks > 1) {
      __syncthreads();
      stage_kv<T, D>(Ks, Vs, kb, vb, sh, key0, n, true);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    for (int kt = 0; kt < n; kt += KT) {
      float s[8][4];
      scores<T, D>(s, qf, Ks + kt * L::LK);
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
  if (!active) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (rows[rr] >= sh.nq) continue;
    T* orow = out + ((b * sh.nq + rows[rr]) * sh.h + h) * D + 2 * t;
#pragma unroll
    for (int jn = 0; jn < NO; ++jn) {
      orow[8 * jn] = Num<T>::from_float(o[jn][2 * rr]);
      orow[8 * jn + 1] = Num<T>::from_float(o[jn][2 * rr + 1]);
    }
  }
}

// plan: K/V chunk keys and CTAs resident per SM at Nk keys; launch: the
// kernel over the chunk that plan gives
template <typename T, int D>
int plan(int nk, int* kc, int* ctas_per_sm) {
  *kc = chunk_keys<T, D>(nk);
  auto kern = attention_kernel<T, D>;
  const int smem = *kc * Pad<T, D>::KEY_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern,
                                                        32 * NW, smem);
  return (int)err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, Shape sh, float scale, cudaStream_t stream) {
  sh.kc = chunk_keys<T, D>(sh.nk);
  const int smem = sh.kc * Pad<T, D>::KEY_BYTES;
  auto kern = attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.nq + 16 * NW - 1) / (16 * NW), sh.h, B);
  kern<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), sh, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const float* bias, void* out, int B, const Shape& sh,
             float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, bias, out, B, sh, scale, s);
    case 16: return launch<T, 16>(q, k, v, bias, out, B, sh, scale, s);
    case 32: return launch<T, 32>(q, k, v, bias, out, B, sh, scale, s);
    case 64: return launch<T, 64>(q, k, v, bias, out, B, sh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_plan(int D, int nk, int* kc, int* ctas_per_sm) {
  switch (D) {
    case 8: return plan<T, 8>(nk, kc, ctas_per_sm);
    case 16: return plan<T, 16>(nk, kc, ctas_per_sm);
    case 32: return plan<T, 32>(nk, kc, ctas_per_sm);
    case 64: return plan<T, 64>(nk, kc, ctas_per_sm);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn
}  // namespace gator

// The plan the launch takes at Nk keys: keys per staged K/V chunk (a
// multiple of 64) into *kc and the CTAs resident per SM on the current
// device into *ctas_per_sm. Returns a cudaError_t.
extern "C" int fused_attention_plan(int dtype, int D, int Nk, int* kc,
                                    int* ctas_per_sm) {
  if (dtype == 0)
    return gator::attn::dispatch_plan<float>(D, Nk, kc, ctas_per_sm);
  return gator::attn::dispatch_plan<__nv_bfloat16>(D, Nk, kc, ctas_per_sm);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); D in {8, 16, 32, 64};
// strides in elements; bias f32 [H, Nq, Nk] contiguous, or null. Returns
// the cudaError_t of the launch.
extern "C" int fused_attention_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* bias, void* out, int B, int Nq, int Nk, int H,
    long long q_b, long long q_n, long long q_h, long long k_b, long long k_n,
    long long k_h, long long v_b, long long v_n, long long v_h, float scale,
    void* stream) {
  const gator::attn::Shape sh{Nq,  Nk,  H,   0,   q_b, q_n, q_h,
                              k_b, k_n, k_h, v_b, v_n, v_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0)
    return gator::attn::dispatch<float>(D, q, k, v, bf, out, B, sh, scale, s);
  return gator::attn::dispatch<__nv_bfloat16>(D, q, k, v, bf, out, B, sh,
                                              scale, s);
}
