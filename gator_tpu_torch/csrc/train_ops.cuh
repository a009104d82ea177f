// Device helpers of the training kernels: K4's FMA launches
// (lbf_stack_train.cu: the three matrix products of a backward pass, column
// sums, norm-parameter sums, the std-LayerNorm backward), and, shared with
// K5 (gat_trunk_train.cu), the LayerNorm backward, GELU's derivative and
// the fixed-order reduction of gradient partials.
//
// Activations are f32 (in shared or CTA-private global scratch). Every
// product rounds its activation operands to the working type T where it
// reads them (`rnd<T>`), as the JAX training kernels cast both operands of
// every matmul to the compute dtype; sums accumulate in f32. Parameter
// gradients are accumulated into f32 partial rows and summed across them
// by `reduce_partials` in a fixed order, so repeat runs are bit-identical
// (no atomics).
#pragma once

#include "common.cuh"
#include "dropout.cuh"

namespace gator {

// out(r, c, sum_k rnd(A[r, k]) * W[k, c]); as `gemm` (common.cuh), with the
// activation operand rounded to T. Each thread owns an RM x 4 output tile.
template <typename T, typename Out>
__device__ __forceinline__ void gemm_nn(const float* A, int lda, int rows,
                                        int K, const T* __restrict__ W,
                                        int ldw, int N, Out out) {
  const int nq = N >> 2;
  const int items = (rows + RM - 1) / RM * nq;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int r0 = item / nq * RM;
    const int c0 = item % nq * 4;
    const float* arow[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) arow[i] = A + min(r0 + i, rows - 1) * lda;
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    const T* wp = W + c0;
    for (int k = 0; k < K; k += 4) {
      float w[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load4(wp + (size_t)(k + kk) * ldw, w[kk]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(arow[i] + k);
        const float ax = rnd<T>(a.x), ay = rnd<T>(a.y), az = rnd<T>(a.z),
                    aw = rnd<T>(a.w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[i][j];
          s = fmaf(ax, w[0][j], s);
          s = fmaf(ay, w[1][j], s);
          s = fmaf(az, w[2][j], s);
          s = fmaf(aw, w[3][j], s);
          acc[i][j] = s;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (r0 + i < rows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) out(r0 + i, c0 + j, acc[i][j]);
      }
    }
  }
}

// out(r, k, sum_n rnd(A[r, n]) * W[k, n]) for k < Kout: a product with the
// transposed weight (W is [Kout, ldw] row-major, the forward's [in, out]).
// Nin % 4 == 0, Kout % 4 == 0, ldw % 4 == 0, lda % 4 == 0. Each thread owns
// an RT x 4 tile, RT = 2 (K4's narrow products over few rows).
template <typename T, typename Out>
__device__ __forceinline__ void gemm_nt(const float* A, int lda, int rows,
                                        int Nin, const T* __restrict__ W,
                                        int ldw, int Kout, Out out) {
  constexpr int RT = 2;
  const int kq = Kout >> 2;
  const int items = (rows + RT - 1) / RT * kq;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int r0 = item / kq * RT;
    const int k0 = item % kq * 4;
    const float* arow[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) arow[i] = A + min(r0 + i, rows - 1) * lda;
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int n = 0; n < Nin; n += 4) {
      float w[4][4];  // w[j][nn] = W[k0 + j, n + nn]
#pragma unroll
      for (int j = 0; j < 4; ++j) load4(W + (size_t)(k0 + j) * ldw + n, w[j]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(arow[i] + n);
        const float ax = rnd<T>(a.x), ay = rnd<T>(a.y), az = rnd<T>(a.z),
                    aw = rnd<T>(a.w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[i][j];
          s = fmaf(ax, w[j][0], s);
          s = fmaf(ay, w[j][1], s);
          s = fmaf(az, w[j][2], s);
          s = fmaf(aw, w[j][3], s);
          acc[i][j] = s;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (r0 + i < rows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) out(r0 + i, k0 + j, acc[i][j]);
      }
    }
  }
}

// G[k * ldg + n] += sum_r rnd(A[r, k]) * rnd(B[r, n]) for k < K, n < N:
// a weight gradient over this CTA's rows. Each thread owns a KT x 4 tile,
// KT = 4 (K4's narrow [64, 64] gradients); K % KT == 0, N % 4 == 0,
// lda % 4 == 0, ldb % 4 == 0. Each (k, n) has one owner thread.
template <typename T>
__device__ __forceinline__ void gemm_tn_acc(const float* A, int lda,
                                            const float* B, int ldb, int rows,
                                            int K, int N, float* G, int ldg) {
  constexpr int KT = 4;
  const int nq = N >> 2;
  const int items = K / KT * nq;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int k0 = item / nq * KT;
    const int n0 = item % nq * 4;
    float acc[KT][4];
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int r = 0; r < rows; ++r) {
      float a[KT];
#pragma unroll
      for (int q = 0; q < KT; q += 4) {
        const float4 av =
            *reinterpret_cast<const float4*>(A + r * lda + k0 + q);
        a[q] = rnd<T>(av.x);
        a[q + 1] = rnd<T>(av.y);
        a[q + 2] = rnd<T>(av.z);
        a[q + 3] = rnd<T>(av.w);
      }
      const float4 bv = *reinterpret_cast<const float4*>(B + r * ldb + n0);
      const float b[4] = {rnd<T>(bv.x), rnd<T>(bv.y), rnd<T>(bv.z),
                          rnd<T>(bv.w)};
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) G[(k0 + i) * ldg + n0 + j] += acc[i][j];
  }
}

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
