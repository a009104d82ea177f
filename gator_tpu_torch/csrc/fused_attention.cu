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
// B1 = joints), both read from the qkv product's strided view.
//
// Numerics, as the TPU kernel: scores and softmax in f32; the normalised
// probabilities rounded to v's dtype before the PV product, which
// accumulates in f32, on the tensor cores (bf16 m16n8k16, or in f32 the
// 3xTF32 split; TF32 is never used alone).
//
// Design. One CTA of eight warps per (128-query tile, head, sample) (four
// warps measured 10 % slower on the H100); each warp owns 16 query rows.
// The body is attn_tc.cuh's two-pass attention, shared with K2's
// self-attention (lbf_stack.cu): the (sample, head)'s K and V staged in
// shared memory in their own dtype with cp.async, in chunks of `kc` keys
// sized so that two CTAs fit on an SM (one chunk, staged once, whenever
// the keys fit: bf16 at Nk = 431; f32 there takes two); pass 1 takes each
// row's max and sum online, pass 2 recomputes the scores and runs
// T(exp(s - max) / sum) v, so nothing of the [Nq, Nk] score tile is
// stored. This file adds the optional bias and the strided layouts.
//
// What bounds it on the H100. At the eval shape (B = 512) the work is
// 2 * 512 * 2 * 431 * 431 * 32 = 12.2 GFMA, twice that with pass 1's
// scores, against 226 MB of q, k, v and out (0.068 ms at 3.35 TB/s): on
// the tensor cores (bf16 0.05 ms for the 24 GFMA at 989 TFLOP/s) the bytes
// bound it; in f32 the three TF32 products and the splits (0.30 ms at
// 495 TFLOP/s for the products alone), and in both the two exponentials
// per score.
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
// (f32 at D = 64 takes 174 without the cap). SPLIT: a sample is the pair
// (b, b1) and out has the caller's strides; without it (one batch
// dimension, out contiguous) the addressing is the plain [B, N, H, D] one,
// which keeps the eval shape's registers: the general addressing on every
// launch measured 5-6 % slower there in bf16.
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
