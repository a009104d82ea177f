// K3: fused attention, softmax(q k^T * scale + bias) v, with no probability
// tensor in device memory.
//
// Replaces gator_tpu/nn/pallas_attention.py:142 `fused_attention` (kernels
// `_kernel:31` and `_kernel_bias:49`, pallas_calls `:84` and `:94`).
// q [B, Nq, H, D], k and v [B, Nk, H, D] in the caller's strides (the last
// dimension contiguous), an optional f32 bias [H, Nq, Nk] shared by every
// sample; out [B, Nq, H, D] contiguous, in q's dtype. On the model's path
// this is the MDR vertex self-attention of the module form (eval): Nq = Nk
// = 431, H = 2, D = 32, no bias.
//
// Numerics, as the TPU kernel: scores and softmax in f32; the normalised
// probabilities rounded to v's dtype before the PV product, which
// accumulates in f32. The whole [rows, Nk] score tile of a CTA sits in
// shared memory, so the softmax is the exact two-pass one (max, sum,
// normalise, round) and rounds where the TPU kernel rounds; a flash-style
// online softmax would round unnormalised probabilities instead.
//
// Design. One CTA per (query-row tile, head, sample). The sample's K and V
// for its head are staged in shared memory as f32 (K rows padded to D + 1
// floats: in the score phase neighbouring threads read neighbouring keys),
// then: scores (each thread holds one key row in registers and runs it
// against RB query rows), softmax (one warp per row), PV (each thread owns
// one column d of several rows). At Nk = 431, D = 32 a 64-row tile takes
// 230,588 bytes of the 232,448 a CTA may have; the host picks fewer rows
// where a tile does not fit and refuses only a shape where one row cannot.
//
// What bounds it on the H100. At the eval shape (B = 512) the work is
// 2 * 512 * 2 * 431 * 431 * 32 = 12.2 GFMA on the f32 pipes (the bf16
// tensor-core bound: 0.025 ms) against 226 MB of q, k, v and out (0.068 ms
// at 3.35 TB/s): the bytes bound it. This first version runs FMA loops at
// one CTA per SM (the tile fills shared memory); tensor cores (mma/wgmma
// for QK^T and PV), K/V kept in bf16 and a smaller tile for two CTAs per
// SM are the next steps.
#include "common.cuh"

namespace gator {
namespace attn {

constexpr int NT = 512;        // threads per CTA
constexpr int ROWS_MAX = 64;   // query rows per CTA at most
constexpr int RB = 8;          // query rows per thread in the score phase

struct Shape {
  int nq, nk, h, rows;
  long long q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, Shape sh, float scale) {
  static_assert(D % 4 == 0 && NT % D == 0 && ROWS_MAX % (NT / D) == 0,
                "head width");
  constexpr int KP = D + 1;           // padded K row
  constexpr int RG = NT / D;          // row groups of the PV phase
  constexpr int RPT = ROWS_MAX / RG;  // rows per thread in the PV phase
  extern __shared__ float smem[];
  const int nk = sh.nk;
  const int r0 = blockIdx.x * sh.rows;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int nr = min(sh.rows, sh.nq - r0);
  float* Qs = smem;                   // [rows, D]
  float* Ks = Qs + sh.rows * D;       // [Nk, D + 1]
  float* Vs = Ks + nk * KP;           // [Nk, D]
  float* S = Vs + nk * D;             // [rows, Nk]
  const int tid = threadIdx.x;

  const T* qb = q + b * sh.q_b + h * sh.q_h + r0 * sh.q_n;
  const T* kb = k + b * sh.k_b + h * sh.k_h;
  const T* vb = v + b * sh.v_b + h * sh.v_h;
  for (int i = tid; i < nr * D; i += NT) {
    const int r = i / D, d = i % D;
    Qs[i] = ld(qb + r * sh.q_n + d);
  }
  for (int i = tid; i < nk * D; i += NT) {
    const int j = i / D, d = i % D;
    Ks[j * KP + d] = ld(kb + j * sh.k_n + d);
    Vs[i] = ld(vb + j * sh.v_n + d);
  }
  __syncthreads();

  // scores: s = (q . k) * scale (+ bias), f32
  const float* bh =
      bias == nullptr ? nullptr : bias + ((size_t)h * sh.nq + r0) * nk;
  const int groups = (nr + RB - 1) / RB;
  for (int item = tid; item < groups * nk; item += NT) {
    const int g = item / nk, j = item % nk;
    float kr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) kr[d] = Ks[j * KP + d];
    const int rend = min(RB, nr - g * RB);
    for (int rr = 0; rr < rend; ++rr) {
      const int r = g * RB + rr;
      const float4* qr = reinterpret_cast<const float4*>(Qs + r * D);
      float s = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = qr[d4];
        s = fmaf(qv.x, kr[4 * d4], s);
        s = fmaf(qv.y, kr[4 * d4 + 1], s);
        s = fmaf(qv.z, kr[4 * d4 + 2], s);
        s = fmaf(qv.w, kr[4 * d4 + 3], s);
      }
      s *= scale;
      if (bh != nullptr) s += bh[(size_t)r * nk + j];
      S[r * nk + j] = s;
    }
  }
  __syncthreads();

  // softmax, one warp per row: p = exp(s - max) / sum, rounded to T
  const int lane = tid & 31;
  for (int r = tid >> 5; r < nr; r += NT / 32) {
    float* row = S + r * nk;
    float m = -CUDART_INF_F;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < nk; j += 32) row[j] = rnd<T>(row[j] / sum);
  }
  __syncthreads();

  // out = p v, f32 sums; thread (rg, d) owns rows rg, rg + RG, ...
  const int d = tid % D, rg = tid / D;
  const int mine = nr > rg ? (nr - rg + RG - 1) / RG : 0;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;
  for (int j = 0; j < nk; ++j) {
    const float vv = Vs[j * D + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (i < mine) acc[i] = fmaf(S[(rg + RG * i) * nk + j], vv, acc[i]);
  }
  T* ob = out + ((b * sh.nq + r0) * sh.h + h) * D + d;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    if (i < mine)
      ob[(size_t)(rg + RG * i) * sh.h * D] = Num<T>::from_float(acc[i]);
}

// Shared memory of one CTA, in floats.
__host__ __device__ constexpr long long smem_floats(int rows, int nk, int d) {
  return (long long)rows * d + (long long)nk * (d + 1) + (long long)nk * d +
         (long long)rows * nk;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, const Shape& sh, float scale,
           cudaStream_t stream) {
  auto kern = attention_kernel<T, D>;
  const int smem = (int)(smem_floats(sh.rows, sh.nk, D) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.nq + sh.rows - 1) / sh.rows, sh.h, B);
  kern<<<grid, NT, smem, stream>>>(
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

}  // namespace attn
}  // namespace gator

// Query rows per CTA: the most (up to 64, and at most Nq) whose tile fits
// in `smem_bytes` of shared memory; 0 when not even one row fits.
extern "C" int fused_attention_rows(int Nq, int Nk, int D, int smem_bytes) {
  int rows = Nq < gator::attn::ROWS_MAX ? Nq : gator::attn::ROWS_MAX;
  while (rows > 0 && gator::attn::smem_floats(rows, Nk, D) *
                             (long long)sizeof(float) > smem_bytes)
    --rows;
  return rows;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); D in {8, 16, 32, 64};
// strides in elements; bias f32 [H, Nq, Nk] contiguous, or null. Returns
// the cudaError_t of the launch.
extern "C" int fused_attention_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* bias, void* out, int B, int Nq, int Nk, int H, int rows,
    long long q_b, long long q_n, long long q_h, long long k_b, long long k_n,
    long long k_h, long long v_b, long long v_n, long long v_h, float scale,
    void* stream) {
  const gator::attn::Shape sh{Nq,  Nk,  H,   rows, q_b, q_n, q_h,
                              k_b, k_n, k_h, v_b,  v_n, v_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0)
    return gator::attn::dispatch<float>(D, q, k, v, bf, out, B, sh, scale, s);
  return gator::attn::dispatch<__nv_bfloat16>(D, q, k, v, bf, out, B, sh,
                                              scale, s);
}
