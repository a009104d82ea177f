// Device helpers of the training kernels: K4's row-local backward
// (lbf_stack_train.cu: column sums, norm-parameter sums, the std-LayerNorm
// backward), and, shared with K5 (gat_trunk_train.cu), the LayerNorm
// backward, GELU's derivative and the fixed-order reduction of K5's
// gradient partials.
//
// Activations and cotangents are f32 in shared memory; sums accumulate in
// f32. Parameter gradients are accumulated into f32 partial rows and summed
// across them in a fixed order, so repeat runs are bit-identical (no
// atomics).
#pragma once

#include "common.cuh"
#include "dropout.cuh"

namespace gator {

// G[c] += sum_r buf[r * ld + c] for c < N (a bias gradient)
__device__ __forceinline__ void colsum_acc(const float* buf, int ld, int rows,
                                           int N, float* G) {
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += buf[r * ld + c];
    G[c] += s;
  }
}

// Backward of y = (x - mean) * rsqrt(var + eps) * w + b (biased variance)
// over rows of width C, one warp per row (gator_tpu/nn/pallas_mdr_train.py
// `_ln_bwd`). out(r, c, dx); stats[2r], stats[2r+1] = mean, rstd.
template <int C, typename T, typename Out>
__device__ __forceinline__ void ln_bwd_rows(const float* DY, int ldy,
                                            const float* X, int ldx, int rows,
                                            const T* w, float eps,
                                            float* stats, Out out) {
  constexpr int PER = C / 32;
  const int lane = threadIdx.x & 31;
  const int nwarp = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarp) {
    float xh[PER], g[PER];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      xh[i] = X[r * ldx + lane + 32 * i];
      s += xh[i];
    }
    const float mean = warp_sum(s) * (1.0f / C);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      xh[i] -= mean;
      q += xh[i] * xh[i];
    }
    const float rstd = rsqrtf(warp_sum(q) * (1.0f / C) + eps);
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      xh[i] *= rstd;
      g[i] = DY[r * ldy + c] * ld(w + c);
      sg += g[i];
      sgx += g[i] * xh[i];
    }
    const float mg = warp_sum(sg) * (1.0f / C);
    const float mgx = warp_sum(sgx) * (1.0f / C);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i)
      out(r, lane + 32 * i, rstd * (g[i] - mg - xh[i] * mgx));
    if (lane == 0) {
      stats[2 * r] = mean;
      stats[2 * r + 1] = rstd;
    }
  }
}

// Backward of the std-LayerNorm a * (x - mean) / (std + eps) + b with the
// n-1 std (`_stdln_bwd`). stats[2r], stats[2r+1] = mean, 1 / (std + eps).
template <int C, typename T, typename Out>
__device__ __forceinline__ void stdln_bwd_rows(const float* DY, int ldy,
                                               const float* X, int ldx,
                                               int rows, const T* a,
                                               float eps, float* stats,
                                               Out out) {
  constexpr int PER = C / 32;
  const int lane = threadIdx.x & 31;
  const int nwarp = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarp) {
    float u[PER], g[PER];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      u[i] = X[r * ldx + lane + 32 * i];
      s += u[i];
    }
    const float mean = warp_sum(s) * (1.0f / C);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      u[i] -= mean;
      q += u[i] * u[i];
    }
    const float sd = sqrtf(warp_sum(q) / (C - 1));
    const float denom = sd + eps;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      g[i] = DY[r * ldy + c] * ld(a + c);
      s1 += g[i];
      s2 += g[i] * u[i];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float k2 = s2 / ((C - 1) * fmaxf(sd, 1e-20f) * denom * denom);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i)
      out(r, lane + 32 * i, (g[i] - s1 / C) / denom - u[i] * k2);
    if (lane == 0) {
      stats[2 * r] = mean;
      stats[2 * r + 1] = 1.0f / denom;
    }
  }
}

// Gradients of a norm's weight and bias from the rows' saved statistics:
// Gw[c] += sum_r DY * (X - mean) * inv, Gb[c] += sum_r DY.
__device__ __forceinline__ void norm_param_acc(const float* DY, int ldy,
                                               const float* X, int ldx,
                                               const float* stats, int rows,
                                               int C, float* Gw, float* Gb) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sw = 0.0f, sb = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const float dy = DY[r * ldy + c];
      sw += dy * (X[r * ldx + c] - stats[2 * r]) * stats[2 * r + 1];
      sb += dy;
    }
    Gw[c] += sw;
    Gb[c] += sb;
  }
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
  return cdf + x * pdf;
}

// out[p] = sum_{i < nparts} part[i * stride + p], in order of i
__global__ void __launch_bounds__(256)
    reduce_partials_kernel(const float* __restrict__ part, int nparts,
                           long long stride, int n, float* __restrict__ out) {
  const int p = blockIdx.x * 256 + threadIdx.x;
  if (p >= n) return;
  float s = 0.0f;
  for (int i = 0; i < nparts; ++i) s += part[(size_t)i * stride + p];
  out[p] = s;
}

inline int reduce_partials(const float* part, int nparts, long long stride,
                           int n, float* out, cudaStream_t stream) {
  reduce_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, nparts,
                                                             stride, n, out);
  return (int)cudaGetLastError();
}

}  // namespace gator
