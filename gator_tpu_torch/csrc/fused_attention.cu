// K3: fused attention, softmax(q k^T * scale + bias) v, with no probability
// tensor in device memory.
//
// Replaces gator_tpu/nn/pallas_attention.py:142 `fused_attention` (kernels
// `_kernel:31` and `_kernel_bias:49`, pallas_calls `:84` and `:94`).
// q [B, B1, Nq, H, D], k and v [B, B1, Nk, H, D] in the caller's strides
// (the last dimension contiguous, rows 16-byte aligned), an optional f32
// bias [H, Nq, Nk] shared by every sample; out [B, B1, Nq, H, D] in q's
// dtype, in the caller's strides too. A sample is a (b, b1) pair, so that
// rows one batch stride cannot address (MotionBERT's temporal attention:
// the frames of one joint of one clip) are read and written in place.
// On the model's paths: the MDR vertex self-attention of the module form
// (eval): Nq = Nk = 431, H = 2, D = 32, no bias, B1 = 1; MotionBERT's
// serving call (models/motionbert.py), H = 8, D = 64: the spatial
// attention over the 17 joints of each frame (B = clips x frames, B1 = 1)
// and the temporal attention over the 16 frames of each joint (B = clips,
// B1 = joints), both read from the qkv product's strided view; HMR 2.0's
// serving call (models/hmr2.py): the ViT-H backbone's self-attention over
// its 192 patch tokens, H = 16, D = 80 (tiled), its decoder's
// cross-attention of one query against those 192 tokens, H = 8, D = 64
// (tiled), and the decoder's one-token self-attention (short).
//
// Numerics, as the TPU kernel: scores and softmax in f32; the normalised
// probabilities rounded to v's dtype before the PV product, which
// accumulates in f32, on the tensor cores (bf16 m16n8k16, or in f32 the
// 3xTF32 split; TF32 is never used alone).
//
// Two kernels, routed by the caller (nn/fused_attention.py `route`) on Nq
// and Nk alone; they share the numerics and no tiling.
//
// Tiled (`attn::attention_kernel<T, D, SPLIT>`), for long rows: one CTA of
// eight warps per (128-query tile, head, sample) (four warps measured 10 %
// slower on the H100); each warp owns 16 query rows. The body is
// attn_tc.cuh's two-pass attention, shared with K2's self-attention
// (lbf_stack.cu): the (sample, head)'s K and V staged in shared memory in
// their own dtype with cp.async, in chunks of `kc` keys sized so that two
// CTAs fit on an SM (one chunk, staged once, whenever the keys fit: bf16
// at Nk = 431; f32 there takes two); pass 1 takes each row's max and sum
// online, pass 2 recomputes the scores and runs T(exp(s - max) / sum) v,
// so nothing of the [Nq, Nk] score tile is stored. This file adds the
// optional bias and the strided layouts.
//
// Short rows (`attn_short::attention_kernel<T, D>`), Nq <= 32 and Nk <=
// 32: at 16-17 tokens the tiled CTA has one or two warps with rows, and
// its grid is tens of thousands of CTAs of a few microseconds, each
// zero-filling a 64-key tile and computing the scores twice. Here a warp
// owns one (sample, head): one m16 query tile, or two past 16 queries. A
// CTA takes whole samples, all their heads (a group of heads where a
// sample's rows outgrow the ring; several samples where H < 8), and is
// persistent: CTAs resident an SM times the SMs walk over the samples
// through a two-stage shared-memory ring, the next sample's q, k and v
// rows in flight (cp.async, 16 bytes a thread, a token's heads
// contiguous) while this one is computed. One pass: a row's <= 32 scores
// stay in registers, and the max, the in-order sum of exp2 and p =
// T(exp2(s - max) * (1 / sum)) are two_pass's arithmetic at one key
// chunk, so the outputs are the tiled kernel's bits. The output goes
// through shared memory (into the q rows it replaces) and out in the
// caller's strides in 16-byte stores.
//
// What bounds it on the H100. Tiled, at the eval shape (B = 512): the work
// is 2 * 512 * 2 * 431 * 431 * 32 = 12.2 GFMA, twice that with pass 1's
// scores, against 226 MB of q, k, v and out (0.068 ms at 3.35 TB/s): on
// the tensor cores (bf16 0.05 ms for the 24 GFMA at 989 TFLOP/s) the bytes
// bound it; in f32 the three TF32 products and the splits (0.30 ms at
// 495 TFLOP/s for the products alone), and in both the two exponentials
// per score. Short, at MotionBERT's shapes (2,048 frames of 17 joints, or
// 128 clips x 17 joints of 16 frames; 8 heads of 64, bf16): 142.6 MB of
// q, k, v and out a launch, 0.0426 ms at 3.35 TB/s, against products a
// fortieth of that: the bytes, so the ring keeps a sample in flight while
// one is computed, in each of two CTAs an SM (bf16).
#include "attn_tc.cuh"

namespace gator {
namespace attn {

constexpr int NW = 8;  // warps per CTA, 16 query rows each

struct Shape {
  int nq, nk, h, kc, nb1;
  long long q_b, q_b1, q_n, q_h, k_b, k_b1, k_n, k_h, v_b, v_b1, v_n, v_h;
  long long o_b, o_b1, o_n, o_h;
};

// two CTAs per SM at every head width: at most 128 registers a thread
// (f32 at D = 64 takes 174 without the cap; f32 at D = 80 spills under it,
// a path no cell runs: HMR 2.0 serves its 80-wide heads in bf16). SPLIT:
// a sample is the pair (b, b1) and out has the caller's strides; without
// it (one batch dimension, out contiguous) the addressing is the plain
// [B, N, H, D] one, which keeps the eval shape's registers: the general
// addressing on every launch measured 5-6 % slower there in bf16.
template <typename T, int D, bool SPLIT>
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
  // the sample of this CTA: blockIdx.z = b * nb1 + b1
  const long long b = SPLIT ? blockIdx.z / sh.nb1 : blockIdx.z;
  const long long b1 = SPLIT ? blockIdx.z - b * sh.nb1 : 0;
  const int m0 = blockIdx.x * 16 * NW + (threadIdx.x >> 5) * 16;
  const bool active = m0 < sh.nq;
  const int nk = sh.nk;
  const T* qb =
      q + b * sh.q_b + b1 * sh.q_b1 + h * sh.q_h + (long long)m0 * sh.q_n;
  const T* kb = k + b * sh.k_b + b1 * sh.k_b1 + h * sh.k_h;
  const T* vb = v + b * sh.v_b + b1 * sh.v_b1 + h * sh.v_h;
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

  float o[NO][4];
  two_pass<T, D, D>(
      o, qf, Ks, Vs, nk, sh.kc, active,
      [&](int key0, int n, bool with_v) {
        stage_kv<T, D>(Ks, Vs, kb, vb, sh.k_n, sh.v_n, key0, n, with_v);
      },
      finish);
  if (!active) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (rows[rr] >= sh.nq) continue;
    T* orow = SPLIT ? out + b * sh.o_b + b1 * sh.o_b1 + rows[rr] * sh.o_n +
                          h * sh.o_h + 2 * t
                    : out + ((b * sh.nq + rows[rr]) * sh.h + h) * D + 2 * t;
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
  auto kern = attention_kernel<T, D, false>;
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
  const bool split = sh.nb1 != 1 || sh.o_h != D ||
                     sh.o_n != (long long)sh.h * D ||
                     sh.o_b != (long long)sh.nq * sh.h * D;
  auto kern =
      split ? attention_kernel<T, D, true> : attention_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.nq + 16 * NW - 1) / (16 * NW), sh.h, B * sh.nb1);
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
    case 80: return launch<T, 80>(q, k, v, bias, out, B, sh, scale, s);
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
    case 80: return plan<T, 80>(nk, kc, ctas_per_sm);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn
}  // namespace gator

namespace gator {
namespace attn_short {

using attn::LOG2E;
using attn::Shape;

constexpr int NW = 8;           // warps a CTA, one (sample, head) pair each
constexpr int MAX_TOKENS = 32;  // queries, keys: two m16 tiles, 4 key groups
constexpr int NJ = MAX_TOKENS / 8;  // 8-key groups of a row's scores
constexpr long long SMEM_MAX = 227 * 1024;  // dynamic shared memory a CTA

// A head's q, k or v row staged in shared memory: WS elements (bf16 at
// D = 8 pads to the mma step's 16 with zeros), in 16-byte pieces of V
// elements, CPR of them a head. ZROW: the length of the zero row that
// stands for every key row past Nk, a head's widest read (64 up to D = 64).
template <typename T, int D>
struct Geo {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int WS = !F32 && D < 16 ? 16 : D;
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int CPR = D / V;
  static constexpr int ZROW = D > 64 ? D : 64;
};

// The launch's plan. A unit is one sample's group of `hg` heads (hg = H
// when a sample fits the ring; else the largest divisor of H that does); a
// ring stage holds `upi` units (more than one only for H < NW), staged as
// rows of every head of a token: q [upi][nq][lq], k [upi][nk][lk], v
// [upi][nk][lv] elements, `stage` elements in all.
struct Plan {
  int hg, groups, upi, lq, lk, lv, stage;
  unsigned units;
  long long items;
};

// The plan at `samples` samples. Staged row lengths are 16-byte aligned,
// and padded so that a warp's fragment reads hit distinct banks: f32 K and
// q rows at 4 mod 8 words, V rows at 8 or 24 mod 32 (scalar reads); bf16
// rows 8 elements past a multiple of 16 (ldmatrix).
template <typename T, int D>
Plan make_plan(const Shape& sh, unsigned samples) {
  using G = Geo<T, D>;
  Plan p{};
  auto bytes = [&](int upi) {
    return (G::ZROW + 2LL * upi * (sh.nq * (long long)p.lq +
                                sh.nk * (long long)(p.lk + p.lv))) *
           (long long)sizeof(T);
  };
  for (p.hg = sh.h;; --p.hg) {
    if (sh.h % p.hg) continue;
    const int base = p.hg * G::WS;
    p.lq = p.lk = G::F32 ? base + 4 : base + 8;
    p.lv = G::F32 ? base + (base % 16 ? 0 : 8) : base + 8;
    if (p.hg == 1 || bytes(1) <= SMEM_MAX) break;
  }
  p.groups = sh.h / p.hg;
  p.upi = 1;
  if (p.groups == 1)
    while (2 * p.upi * sh.h <= NW && bytes(2 * p.upi) <= SMEM_MAX) p.upi *= 2;
  p.stage = p.upi * (sh.nq * p.lq + sh.nk * (p.lk + p.lv));
  p.units = samples * (unsigned)p.groups;
  p.items = ((long long)p.units + p.upi - 1) / p.upi;
  return p;
}

// Unit uu of an item: its sample (b, b1) and first head; `ok` is false
// past the last unit.
struct Unit {
  long long b, b1;
  int h0;
  bool ok;
};

__device__ __forceinline__ Unit unit_of(const Plan& p, const Shape& sh,
                                        long long item, int uu) {
  const long long u = item * p.upi + uu;
  Unit r{0, 0, 0, u < (long long)p.units};
  if (!r.ok) return r;
  const unsigned s = (unsigned)u / (unsigned)p.groups;
  r.h0 = ((unsigned)u - s * (unsigned)p.groups) * p.hg;
  r.b = s / (unsigned)sh.nb1;
  r.b1 = s - r.b * sh.nb1;
  return r;
}

// f(element offset in the stage, element offset in global memory) for
// every 16-byte piece of n token rows (staged `ld` apart) of the item's
// units: the warps over the tokens, the lanes over the pieces of the
// unit's heads
template <typename T, int D, class F>
__device__ __forceinline__ void rows(const Plan& p, const Shape& sh,
                                     long long item, int n, long long s_b,
                                     long long s_b1, long long s_n,
                                     long long s_h, int ld, F f) {
  using G = Geo<T, D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int uu = 0; uu < p.upi; ++uu) {
    const Unit u = unit_of(p, sh, item, uu);
    if (!u.ok) break;
    for (int tok = warp; tok < n; tok += NW) {
      const long long src = u.b * s_b + u.b1 * s_b1 + tok * s_n + u.h0 * s_h;
      const int dst = (uu * n + tok) * ld;
      for (int j = lane; j < p.hg * G::CPR; j += 32) {
        const int hh = j / G::CPR, c = j % G::CPR * G::V;
        f(dst + hh * G::WS + c, src + hh * s_h + c);
      }
    }
  }
}

// start the cp.async copies of an item's q, k and v rows into stage `st`
template <typename T, int D>
__device__ __forceinline__ void stage_item(const Plan& p, const Shape& sh,
                                           long long item, T* st, const T* q,
                                           const T* k, const T* v) {
  T* qs = st;
  T* ks = qs + p.upi * sh.nq * p.lq;
  T* vs = ks + p.upi * sh.nk * p.lk;
  rows<T, D>(p, sh, item, sh.nq, sh.q_b, sh.q_b1, sh.q_n, sh.q_h, p.lq,
             [&](int d, long long s) { tc::cp_async16(qs + d, q + s); });
  rows<T, D>(p, sh, item, sh.nk, sh.k_b, sh.k_b1, sh.k_n, sh.k_h, p.lk,
             [&](int d, long long s) { tc::cp_async16(ks + d, k + s); });
  rows<T, D>(p, sh, item, sh.nk, sh.v_b, sh.v_b1, sh.v_n, sh.v_h, p.lv,
             [&](int d, long long s) { tc::cp_async16(vs + d, v + s); });
}

// o = T(softmax(q k^T * scale + bias)) v for one head of one unit, in one
// pass: the warp's query rows in m16 tiles (rows past nq read as zero),
// each row's <= 32 scores in registers. The arithmetic is two_pass's
// (attn_tc.cuh) at one key chunk: the same mma chains, the row max and
// the in-order sum of exp2, p = T(exp2(s - max) * (1 / sum)); the 8-key
// groups and 16-key PV steps past the last key, which add exact zeros
// there, are skipped, and key rows past nk read the zero row. The output
// overwrites the head's q columns (rows < nq), which no other warp reads.
template <typename T, int D>
__device__ __forceinline__ void attend(T* qs, const T* kst, const T* vst,
                                       const T* zrow, const Plan& p, int nq,
                                       int nk, const float* bh, float scale) {
  using Pm = tc::Mma<T>;
  constexpr int KSTEPS = attn::ksteps<T, D>();
  constexpr int NO = D / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nj = (nk + 7) / 8;
  const float sl = scale * LOG2E;
  for (int m0 = 0; m0 < nq; m0 += 16) {
    typename Pm::A qf[KSTEPS];
    {
      auto qa = [&](int m, int d) {
        return m0 + m < nq && d < D ? ld(qs + (m0 + m) * p.lq + d) : 0.0f;
      };
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        qf[ks] = Pm::load_a(qa, 0, ks * Pm::KS);
    }
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= nj) continue;
        typename Pm::B b;
        if constexpr (sizeof(T) == 4) {
          const int key = 8 * j + g;
          const float* kr =
              reinterpret_cast<const float*>(kst) + key * p.lk + ks * 8 + t;
          tc::split_tf32(key < nk ? kr[0] : 0.0f, b.hi[0], b.lo[0]);
          tc::split_tf32(key < nk ? kr[4] : 0.0f, b.hi[1], b.lo[1]);
        } else {
          const int key = 8 * j + (lane & 7);
          const int col = ks * 16 + ((lane >> 3) & 1) * 8;
          tc::ldsm_x2(b.r, key < nk ? kst + key * p.lk + col : zrow + col);
        }
        Pm::mma(s[j], qf[ks], b);
      }
    }
    // base-2 logits, -inf past the last key (attention_kernel's finish)
    const int rw[2] = {m0 + g, m0 + g + 8};
    if (bh != nullptr) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 8 * j + 2 * t + (i & 1);
          const int row = rw[i >> 1];
          const float bv =
              row < nq && key < nk ? bh[(size_t)row * nk + key] : 0.0f;
          s[j][i] = (s[j][i] * scale + bv) * LOG2E;
        }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] *= sl;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (8 * j + 2 * t + (i & 1) >= nk) s[j][i] = -CUDART_INF_F;
    // the row max and sum, as two_pass's pass 1 over its one key tile
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float tm = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        tm = fmaxf(tm, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      const float mn = fmaxf(mx[rr], attn::quad_max(tm));
      float acc = l[rr] * exp2f(mx[rr] - mn);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc += exp2f(s[j][2 * rr] - mn) + exp2f(s[j][2 * rr + 1] - mn);
      l[rr] = acc;
      mx[rr] = mn;
    }
    const float sum[2] = {attn::quad_sum(l[0]), attn::quad_sum(l[1])};
    const float inv[2] = {1.0f / sum[0], 1.0f / sum[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[j][i] = exp2f(s[j][i] - mx[i >> 1]) * inv[i >> 1];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = rnd<T>(s[j][i]);
    // o = p v (attn_tc.cuh's pv, key rows past nk from the zero row)
    float o[NO][4];
#pragma unroll
    for (int jn = 0; jn < NO; ++jn)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[jn][i] = 0.0f;
    if constexpr (sizeof(T) == 4) {
      const int src0 = (lane & ~3) | (t >> 1), src1 = src0 + 2;
      const bool odd = t & 1;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= nj) continue;
        float x[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = __shfl_sync(0xffffffffu, s[j][i], src0);
          x[4 + i] = __shfl_sync(0xffffffffu, s[j][i], src1);
        }
        typename Pm::A a;
        tc::split_tf32(odd ? x[1] : x[0], a.hi[0], a.lo[0]);
        tc::split_tf32(odd ? x[3] : x[2], a.hi[1], a.lo[1]);
        tc::split_tf32(odd ? x[5] : x[4], a.hi[2], a.lo[2]);
        tc::split_tf32(odd ? x[7] : x[6], a.hi[3], a.lo[3]);
        const int r0 = 8 * j + t, r1 = r0 + 4;
        const float* v0 = reinterpret_cast<const float*>(vst) + r0 * p.lv + g;
        const float* v1 = reinterpret_cast<const float*>(vst) + r1 * p.lv + g;
#pragma unroll
        for (int jn = 0; jn < NO; ++jn) {
          typename Pm::B bv;
          tc::split_tf32(r0 < nk ? v0[8 * jn] : 0.0f, bv.hi[0], bv.lo[0]);
          tc::split_tf32(r1 < nk ? v1[8 * jn] : 0.0f, bv.hi[1], bv.lo[1]);
          Pm::mma(o[jn], a, bv);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        if (16 * kk >= nk) continue;
        typename Pm::A a;
        a.r[0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a.r[1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a.r[2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a.r[3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const int key = 16 * kk + (lane & 15);
        const T* vr = key < nk ? vst + key * p.lv : zrow;
#pragma unroll
        for (int jn = 0; jn < NO; ++jn) {
          typename Pm::B bv;
          tc::ldsm_x2_trans(bv.r, vr + 8 * jn);
          Pm::mma(o[jn], a, bv);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (rw[rr] >= nq) continue;
      T* orow = qs + rw[rr] * p.lq + 2 * t;
#pragma unroll
      for (int jn = 0; jn < NO; ++jn)
        st2(orow + 8 * jn, o[jn][2 * rr], o[jn][2 * rr + 1]);
    }
  }
}

// Persistent: each CTA walks over items (one sample's heads, or several
// whole samples) blockIdx.x, + gridDim.x, ..., through a two-stage ring;
// the next item's cp.async copies are in flight while this one is
// computed and written out. Every warp takes (unit, head) pairs warp,
// warp + NW, ... of the item.
template <typename T, int D>
__global__ void __launch_bounds__(32 * NW, sizeof(T) == 2 ? 2 : 1)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, Shape sh, Plan p, float scale) {
  using G = Geo<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* zrow = reinterpret_cast<T*>(smem);
  T* ring = zrow + G::ZROW;
  // zeros once: the zero row, and the pad columns no copy writes
  {
    const int n16 = (G::ZROW + 2 * p.stage) * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  long long item = blockIdx.x;
  if (item < p.items) stage_item<T, D>(p, sh, item, ring, q, k, v);
  tc::cp_async_commit();
  const int warp = threadIdx.x >> 5;
  for (int it = 0; item < p.items; ++it, item += gridDim.x) {
    T* st = ring + (it & 1) * p.stage;
    tc::cp_async_wait<0>();
    __syncthreads();  // this item is staged; the last one is written out
    const long long next = item + gridDim.x;
    if (next < p.items)
      stage_item<T, D>(p, sh, next, ring + ((it + 1) & 1) * p.stage, q, k,
                       v);
    tc::cp_async_commit();
    T* qs = st;
    const T* ks = qs + p.upi * sh.nq * p.lq;
    const T* vs = ks + p.upi * sh.nk * p.lk;
    for (int pair = warp; pair < p.upi * p.hg; pair += NW) {
      const int uu = pair / p.hg, hh = pair - uu * p.hg;
      const Unit u = unit_of(p, sh, item, uu);
      if (!u.ok) break;
      const float* bh = bias == nullptr
                            ? nullptr
                            : bias + (size_t)(u.h0 + hh) * sh.nq * sh.nk;
      attend<T, D>(qs + uu * sh.nq * p.lq + hh * G::WS,
                   ks + uu * sh.nk * p.lk + hh * G::WS,
                   vs + uu * sh.nk * p.lv + hh * G::WS, zrow, p, sh.nq,
                   sh.nk, bh, scale);
    }
    __syncthreads();
    // out in the caller's strides, 16 bytes a thread
    rows<T, D>(p, sh, item, sh.nq, sh.o_b, sh.o_b1, sh.o_n, sh.o_h, p.lq,
               [&](int d, long long s) {
                 *reinterpret_cast<uint4*>(out + s) =
                     *reinterpret_cast<const uint4*>(qs + d);
               });
  }
}

// The launch at B x B1 samples: its plan, shared-memory bytes, CTAs
// resident an SM on the current device and CTAs launched (no more than
// the items). Returns a cudaError_t.
template <typename T, int D>
int configure(const Shape& sh, int B, Plan* p, int* smem, int* ctas,
              int* grid) {
  *p = make_plan<T, D>(sh, (unsigned)B * (unsigned)sh.nb1);
  *smem = (Geo<T, D>::ZROW + 2 * p->stage) * (int)sizeof(T);
  auto kern = attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern, 32 * NW,
                                                        *smem);
  const long long most = (long long)*ctas * sms;
  *grid = (int)(p->items < most ? p->items : most);
  return (int)err;
}

// out[0] heads a unit, [1] units a ring stage, [2] shared-memory bytes,
// [3] CTAs resident an SM, [4] CTAs launched
template <typename T, int D>
int plan(const Shape& sh, int B, int* out) {
  Plan p;
  const int err = configure<T, D>(sh, B, &p, &out[2], &out[3], &out[4]);
  out[0] = p.hg;
  out[1] = p.upi;
  return err;
}

template <typename T, int D>
int run(const void* q, const void* k, const void* v, const float* bias,
        void* out, int B, const Shape& sh, float scale, cudaStream_t stream) {
  Plan p;
  int smem, ctas, grid;
  const int err = configure<T, D>(sh, B, &p, &smem, &ctas, &grid);
  if (err != (int)cudaSuccess) return err;
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  attention_kernel<T, D><<<grid, 32 * NW, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), sh, p, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const float* bias, void* out, int B, const Shape& sh,
             float scale, cudaStream_t s) {
  switch (D) {
    case 8: return run<T, 8>(q, k, v, bias, out, B, sh, scale, s);
    case 16: return run<T, 16>(q, k, v, bias, out, B, sh, scale, s);
    case 32: return run<T, 32>(q, k, v, bias, out, B, sh, scale, s);
    case 64: return run<T, 64>(q, k, v, bias, out, B, sh, scale, s);
    case 80: return run<T, 80>(q, k, v, bias, out, B, sh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_plan(int D, int B, const Shape& sh, int* out) {
  switch (D) {
    case 8: return plan<T, 8>(sh, B, out);
    case 16: return plan<T, 16>(sh, B, out);
    case 32: return plan<T, 32>(sh, B, out);
    case 64: return plan<T, 64>(sh, B, out);
    case 80: return plan<T, 80>(sh, B, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_short
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); D in {8, 16, 32, 64,
// 80};
// B * B1 samples (at most 65535); strides in elements, per tensor (b, b1,
// n, h); bias f32 [H, Nq, Nk] contiguous, or null. Returns the cudaError_t
// of the launch.
extern "C" int fused_attention_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* bias, void* out, int B, int B1, int Nq, int Nk, int H,
    long long q_b, long long q_b1, long long q_n, long long q_h,
    long long k_b, long long k_b1, long long k_n, long long k_h,
    long long v_b, long long v_b1, long long v_n, long long v_h,
    long long o_b, long long o_b1, long long o_n, long long o_h, float scale,
    void* stream) {
  const gator::attn::Shape sh{Nq,   Nk,  H,   0,    B1,  q_b, q_b1,
                              q_n,  q_h, k_b, k_b1, k_n, k_h, v_b,
                              v_b1, v_n, v_h, o_b,  o_b1, o_n, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0)
    return gator::attn::dispatch<float>(D, q, k, v, bf, out, B, sh, scale, s);
  return gator::attn::dispatch<__nv_bfloat16>(D, q, k, v, bf, out, B, sh,
                                              scale, s);
}

// The short-row kernel, for Nq <= 32 and Nk <= 32 (the caller's route):
// the arguments of fused_attention_launch, with q, k, v and out rows
// 16-byte aligned.
extern "C" int fused_attention_short_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* bias, void* out, int B, int B1, int Nq, int Nk, int H,
    long long q_b, long long q_b1, long long q_n, long long q_h,
    long long k_b, long long k_b1, long long k_n, long long k_h,
    long long v_b, long long v_b1, long long v_n, long long v_h,
    long long o_b, long long o_b1, long long o_n, long long o_h, float scale,
    void* stream) {
  const gator::attn::Shape sh{Nq,   Nk,  H,   0,    B1,  q_b, q_b1,
                              q_n,  q_h, k_b, k_b1, k_n, k_h, v_b,
                              v_b1, v_n, v_h, o_b,  o_b1, o_n, o_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0)
    return gator::attn_short::dispatch<float>(D, q, k, v, bf, out, B, sh,
                                              scale, s);
  return gator::attn_short::dispatch<__nv_bfloat16>(D, q, k, v, bf, out, B,
                                                    sh, scale, s);
}

// The short-row kernel's plan at B x B1 samples of Nq queries, Nk keys and
// H heads on the current device: out[0] heads a unit, [1] units a ring
// stage, [2] shared-memory bytes, [3] CTAs resident an SM, [4] CTAs
// launched. Returns a cudaError_t.
extern "C" int fused_attention_short_plan(int dtype, int D, int B, int B1,
                                          int Nq, int Nk, int H, int* out) {
  gator::attn::Shape sh{};
  sh.nq = Nq;
  sh.nk = Nk;
  sh.h = H;
  sh.nb1 = B1;
  if (dtype == 0)
    return gator::attn_short::dispatch_plan<float>(D, B, sh, out);
  return gator::attn_short::dispatch_plan<__nv_bfloat16>(D, B, sh, out);
}
