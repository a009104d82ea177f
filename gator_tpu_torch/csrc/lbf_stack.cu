// K2: one MDR LBF layer of the serving path as two launches; the host runs
// them once per layer (3 layers).
//
// Replaces gator_tpu/nn/pallas_mdr.py:352 `lbf_stack_fused` (kernel body
// `_kernel_stack:256`). Per layer (reference: lib/models/MDR.py:139-153):
//   x1 = x + Proj(CrossAttn(LN1(x) -> LN1(joints)))     (J joint keys)
//   x2 = x1 + MLP(LN2(x1))                              (exact GELU, 256)
//   y3 = StdLN(x2)                    (n-1 std, eps 1e-6 added to the std)
//   x' = y3 + L3(SelfAttn(L0 y3, L1 y3, L2 y3))         (Nv x Nv, 2 heads)
// The self-attention residual is added to the normalised y3, not to x2.
//
// Design. One head's 431 x 431 score tile is 743 KB in f32, more than a
// CTA's 227 KB of shared memory, so the layer is cut where the rows stop
// being independent:
//   lbf_rows:     per (sample, 32-row tile): the cross-attention over the
//                 whole J-key joint set, LN2, the MLP, the std-LN and the
//                 q2/k2/v2 projections. Writes y3 (f32) and q2/k2/v2 (T).
//   lbf_selfattn: per (sample, 64-query tile), both heads: online softmax
//                 over 64-key tiles staged in shared memory (flash-style;
//                 no score matrix is stored), then L3 and the residual.
// The residual stream between layers stays f32. The ragged 431 edge is
// masked by row counts; the TPU kernel's 431->432 and J->24 row padding
// and its block-diagonal cross mask are gone.
//
// What bounds it on the H100. Both launches are FMA-bound: ~52k FMA per
// vertex row in lbf_rows and 2 * 2 * 32 * Nv FMA per vertex row in
// lbf_selfattn (~49 GFMA per layer at B = 2048), on the f32 pipes. The
// weights (61k values per layer) are read from L2. Tensor cores (mma /
// wgmma for the QK and PV products) are the next step.
#include "common.cuh"

namespace gator {
namespace lbf {

constexpr int C = 64;     // token width
constexpr int H = 2;      // heads
constexpr int D = 32;     // head width
constexpr int HID = 256;  // MLP hidden
constexpr int JMAX = 32;  // most joint tokens
constexpr int TR = 32;    // vertex rows per lbf_rows CTA
constexpr int NT_ROWS = 256;
constexpr int TQ = 64;    // query rows per lbf_selfattn CTA
constexpr int TK = 64;    // keys per staged tile
constexpr int NT_ATTN = TQ * H;

// Field order of one layer's packed weights; must match
// gator_tpu_torch/nn/lbf_stack.py STACK_FIELDS.
enum Field {
  LN1_W, LN1_B, WQ, WK, WV, PROJ_W, PROJ_B, LN2_W, LN2_B,
  FC1_W, FC1_B, FC2_W, FC2_B, A2, B2,
  L0_W, L0_B, L1_W, L1_B, L2_W, L2_B, L3_W, L3_B, NFIELD
};

constexpr int ROWS_SMEM_FLOATS = 3 * TR * C + TR * HID + 2 * JMAX * C;

template <typename T>
__global__ void __launch_bounds__(NT_ROWS)
    lbf_rows_kernel(const float* __restrict__ x, const T* __restrict__ joints,
                    const T* __restrict__ p, const int* __restrict__ offs,
                    float* __restrict__ y3, T* __restrict__ q2,
                    T* __restrict__ k2, T* __restrict__ v2, int Nv, int J) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;          // [TR, C]  residual rows
  float* Y = X + TR * C;    // [TR, C]  LN outputs; scores [TR, H, J]
  float* Qb = Y + TR * C;   // [TR, C]  cross-attention queries
  float* Hb = Qb + TR * C;  // [TR, HID] normalised joints, o, MLP hidden
  float* Kj = Hb + TR * HID;  // [JMAX, C]
  float* Vj = Kj + JMAX * C;  // [JMAX, C]

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int nr = min(TR, Nv - r0);
  const int tid = threadIdx.x;
  const float scale = rsqrtf((float)D);
  const size_t row0 = (size_t)b * Nv + r0;

  for (int i = tid; i < nr * C; i += NT_ROWS) X[i] = x[row0 * C + i];
  for (int i = tid; i < J * C; i += NT_ROWS)
    Hb[i] = Num<T>::to_float(joints[(size_t)b * J * C + i]);
  __syncthreads();

  const T* ln1_w = p + offs[LN1_W];
  const T* ln1_b = p + offs[LN1_B];
  layer_norm_rows<C>(Hb, C, J, ln1_w, ln1_b, 1e-5f, false,
                     [&](int r, int c, float v) { Hb[r * C + c] = rnd<T>(v); });
  layer_norm_rows<C>(X, C, nr, ln1_w, ln1_b, 1e-5f, false,
                     [&](int r, int c, float v) { Y[r * C + c] = rnd<T>(v); });
  __syncthreads();

  gemm<T>(Hb, C, J, C, p + offs[WK], C, C,
          [&](int r, int c, float v) { Kj[r * C + c] = rnd<T>(v); });
  gemm<T>(Hb, C, J, C, p + offs[WV], C, C,
          [&](int r, int c, float v) { Vj[r * C + c] = rnd<T>(v); });
  gemm<T>(Y, C, nr, C, p + offs[WQ], C, C,
          [&](int r, int c, float v) { Qb[r * C + c] = rnd<T>(v); });
  __syncthreads();

  // cross-attention scores [r, h, m] into Y
  float* S = Y;
  for (int i = tid; i < nr * H * J; i += NT_ROWS) {
    const int m = i % J;
    const int h = (i / J) % H;
    const int r = i / (J * H);
    const float* q = Qb + r * C + h * D;
    const float* k = Kj + m * C + h * D;
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(q[d], k[d], s);
    S[i] = s * scale;
  }
  __syncthreads();
  for (int i = tid; i < nr * H; i += NT_ROWS) {
    float* srow = S + i * J;
    float mx = -CUDART_INF_F;
    for (int m = 0; m < J; ++m) mx = fmaxf(mx, srow[m]);
    float sum = 0.0f;
    for (int m = 0; m < J; ++m) sum += expf(srow[m] - mx);
    const float inv = 1.0f / sum;
    for (int m = 0; m < J; ++m) srow[m] = rnd<T>(expf(srow[m] - mx) * inv);
  }
  __syncthreads();
  // o = P @ V into Hb (the normalised joints are no longer needed)
  for (int i = tid; i < nr * C; i += NT_ROWS) {
    const int r = i / C;
    const int c = i % C;
    const float* pr = S + (r * H + c / D) * J;
    float o = 0.0f;
    for (int m = 0; m < J; ++m) o = fmaf(pr[m], Vj[m * C + c], o);
    Hb[i] = rnd<T>(o);
  }
  __syncthreads();

  // x1 = x + o @ Wproj + b
  const T* proj_b = p + offs[PROJ_B];
  gemm<T>(Hb, C, nr, C, p + offs[PROJ_W], C, C, [&](int r, int c, float v) {
    X[r * C + c] += v + ld(proj_b + c);
  });
  __syncthreads();

  // x2 = x1 + fc2(gelu(fc1(LN2(x1))))
  layer_norm_rows<C>(X, C, nr, p + offs[LN2_W], p + offs[LN2_B], 1e-5f, false,
                     [&](int r, int c, float v) { Y[r * C + c] = rnd<T>(v); });
  __syncthreads();
  const T* fc1_b = p + offs[FC1_B];
  gemm<T>(Y, C, nr, C, p + offs[FC1_W], HID, HID, [&](int r, int c, float v) {
    Hb[r * HID + c] = rnd<T>(gelu_exact(v + ld(fc1_b + c)));
  });
  __syncthreads();
  const T* fc2_b = p + offs[FC2_B];
  gemm<T>(Hb, HID, nr, HID, p + offs[FC2_W], C, C, [&](int r, int c, float v) {
    X[r * C + c] += v + ld(fc2_b + c);
  });
  __syncthreads();

  // y3 = StdLN(x2): kept in f32 for the residual, rounded for L0/L1/L2
  layer_norm_rows<C>(X, C, nr, p + offs[A2], p + offs[B2], 1e-6f, true,
                     [&](int r, int c, float v) {
                       y3[(row0 + r) * C + c] = v;
                       Y[r * C + c] = rnd<T>(v);
                     });
  __syncthreads();
  const T* l0_b = p + offs[L0_B];
  const T* l1_b = p + offs[L1_B];
  const T* l2_b = p + offs[L2_B];
  gemm<T>(Y, C, nr, C, p + offs[L0_W], C, C, [&](int r, int c, float v) {
    q2[(row0 + r) * C + c] = Num<T>::from_float(v + ld(l0_b + c));
  });
  gemm<T>(Y, C, nr, C, p + offs[L1_W], C, C, [&](int r, int c, float v) {
    k2[(row0 + r) * C + c] = Num<T>::from_float(v + ld(l1_b + c));
  });
  gemm<T>(Y, C, nr, C, p + offs[L2_W], C, C, [&](int r, int c, float v) {
    v2[(row0 + r) * C + c] = Num<T>::from_float(v + ld(l2_b + c));
  });
}

template <typename T>
__global__ void __launch_bounds__(NT_ATTN)
    lbf_selfattn_kernel(const T* __restrict__ q2, const T* __restrict__ k2,
                        const T* __restrict__ v2, const float* __restrict__ y3,
                        const T* __restrict__ p, const int* __restrict__ offs,
                        float* __restrict__ xout, int Nv) {
  __shared__ __align__(16) float Ks[TK * C];  // key tile; then o [TQ, C]
  __shared__ __align__(16) float Vs[TK * C];

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int h = tid / TQ;   // warps 0-1: head 0, warps 2-3: head 1
  const int r = tid % TQ;
  const int row = min(r0 + r, Nv - 1);
  const float scale = rsqrtf((float)D);
  const size_t base = (size_t)b * Nv;

  float q[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = Num<T>::to_float(q2[(base + row) * C + h * D + d]);
    acc[d] = 0.0f;
  }
  float mx = -CUDART_INF_F;
  float l = 0.0f;

  for (int k0 = 0; k0 < Nv; k0 += TK) {
    const int nk = min(TK, Nv - k0);
    __syncthreads();
    for (int i = tid; i < nk * C; i += NT_ATTN) {
      Ks[i] = Num<T>::to_float(k2[(base + k0) * C + i]);
      Vs[i] = Num<T>::to_float(v2[(base + k0) * C + i]);
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * C + h * D);
      float s = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
        s = fmaf(q[4 * d4], kv.x, s);
        s = fmaf(q[4 * d4 + 1], kv.y, s);
        s = fmaf(q[4 * d4 + 2], kv.z, s);
        s = fmaf(q[4 * d4 + 3], kv.w, s);
      }
      s *= scale;
      if (s > mx) {
        const float corr = expf(mx - s);
        l *= corr;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= corr;
        mx = s;
      }
      const float pr = expf(s - mx);
      l += pr;
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * C + h * D);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] = fmaf(pr, vv.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(pr, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(pr, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(pr, vv.w, acc[4 * d4 + 3]);
      }
    }
  }
  __syncthreads();
  float* O = Ks;
  const float inv = 1.0f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) O[r * C + h * D + d] = rnd<T>(acc[d] * inv);
  __syncthreads();

  // x' = y3 + o @ L3 + b
  const int nq = min(TQ, Nv - r0);
  const T* l3_b = p + offs[L3_B];
  gemm<T>(O, C, nq, C, p + offs[L3_W], C, C, [&](int rr, int c, float v) {
    const size_t i = (base + r0 + rr) * C + c;
    xout[i] = y3[i] + v + ld(l3_b + c);
  });
}

template <typename T>
int launch_rows(const void* x, const void* joints, const void* weights,
                const void* offs, void* y3, void* q2, void* k2, void* v2,
                int B, int Nv, int J, cudaStream_t stream) {
  auto kern = lbf_rows_kernel<T>;
  const int smem = ROWS_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Nv + TR - 1) / TR, B);
  kern<<<grid, NT_ROWS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const T*>(joints),
      static_cast<const T*>(weights), static_cast<const int*>(offs),
      static_cast<float*>(y3), static_cast<T*>(q2), static_cast<T*>(k2),
      static_cast<T*>(v2), Nv, J);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_selfattn(const void* q2, const void* k2, const void* v2,
                    const void* y3, const void* weights, const void* offs,
                    void* xout, int B, int Nv, cudaStream_t stream) {
  dim3 grid((Nv + TQ - 1) / TQ, B);
  lbf_selfattn_kernel<T><<<grid, NT_ATTN, 0, stream>>>(
      static_cast<const T*>(q2), static_cast<const T*>(k2),
      static_cast<const T*>(v2), static_cast<const float*>(y3),
      static_cast<const T*>(weights), static_cast<const int*>(offs),
      static_cast<float*>(xout), Nv);
  return (int)cudaGetLastError();
}

}  // namespace lbf
}  // namespace gator

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its
// launch. x, y3 and xout are f32 [B, Nv, 64]; joints, q2, k2, v2 are T.
extern "C" int lbf_rows_launch(int dtype, const void* x, const void* joints,
                               const void* weights, const void* offs,
                               void* y3, void* q2, void* k2, void* v2, int B,
                               int Nv, int J, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::lbf::launch_rows<float>(x, joints, weights, offs, y3, q2, k2,
                                          v2, B, Nv, J, s);
  return gator::lbf::launch_rows<__nv_bfloat16>(x, joints, weights, offs, y3,
                                                q2, k2, v2, B, Nv, J, s);
}

extern "C" int lbf_selfattn_launch(int dtype, const void* q2, const void* k2,
                                   const void* v2, const void* y3,
                                   const void* weights, const void* offs,
                                   void* xout, int B, int Nv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::lbf::launch_selfattn<float>(q2, k2, v2, y3, weights, offs,
                                              xout, B, Nv, s);
  return gator::lbf::launch_selfattn<__nv_bfloat16>(q2, k2, v2, y3, weights,
                                                    offs, xout, B, Nv, s);
}
