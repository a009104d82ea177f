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
//   rows:         per (32-row tile, sample): the cross-attention over the
//                 whole J-key joint set, LN2, the MLP, the std-LN and the
//                 q2/k2/v2 projections. Writes y3 (f32) and q2/k2/v2 (T).
//                 This is lbf_layer.cuh's `rows_kernel` (shared with
//                 K2-layer and T1) under T1's rounding policy, which is
//                 K2's: products and bias adds in f32, operands rounded to
//                 T where they enter a product.
//   lbf_selfattn: per (sample, 64-query tile), both heads: online softmax
//                 over 64-key tiles staged in shared memory (flash-style;
//                 no score matrix is stored), then L3 and the residual.
// The residual stream between layers stays f32. The ragged 431 edge is
// masked by row counts; the TPU kernel's 431->432 and J->24 row padding
// and its block-diagonal cross mask are gone.
//
// What bounds it on the H100. Both launches are FMA-bound: ~52k FMA per
// vertex row in the rows kernel and 2 * 2 * 32 * Nv FMA per vertex row in
// lbf_selfattn (~49 GFMA per layer at B = 2048), on the f32 pipes. The
// weights (61k values per layer) are read from L2. Tensor cores (mma /
// wgmma for the QK and PV products) are the next step.
#include "lbf_layer.cuh"

namespace gator {
namespace lbf {

using namespace lbf_layer;

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
      s *= kScale;
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
  using gator::lbf_layer::FULL;
  using gator::lbf_layer::launch_rows;
  if (dtype == 0)
    return launch_rows<float, false, FULL, float>(
        x, joints, weights, offs, y3, q2, k2, v2, nullptr, B, Nv, J, s);
  return launch_rows<__nv_bfloat16, false, FULL, float>(
      x, joints, weights, offs, y3, q2, k2, v2, nullptr, B, Nv, J, s);
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
