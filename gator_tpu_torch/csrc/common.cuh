// Device helpers shared by the hand-written kernels: the working type T's
// conversions and rounding, LayerNorm rows, the exact GELU, warp sums.
//
// Where the JAX kernels cast an intermediate to the working dtype T before
// the next matmul, these kernels round to what T would hold (`rnd<T>`, or
// by storing in T), so a bf16 run rounds at the same places while every
// sum still accumulates in f32. The products themselves run on the tensor
// cores (csrc/mma.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace gator {

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16(v);
  }
};

// v as the working type T holds it (round to nearest even for bf16)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Num<T>::to_float(Num<T>::from_float(v));
}

template <typename T>
__device__ __forceinline__ float ld(const T* p) {
  return Num<T>::to_float(*p);
}

// two adjacent values of T at an even index, as f32; and stored from f32
// (each rounded as `Num<T>::from_float` rounds)
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// the E at byte `off` of shared memory `s`
template <typename E>
__device__ __forceinline__ E* at(unsigned char* s, int off) {
  return reinterpret_cast<E*>(s + off);
}

// LayerNorm of `rows` rows of width C (one warp per row), f32 statistics.
// std_form=false: (x - mean) * rsqrt(var + eps) * w + b, biased variance.
// std_form=true: w * (x - mean) / (std + eps) + b with the n-1 std
// (the Annotated-Transformer norm of the MDR stack).
// out(r, c, value); src may be written by `out` (each row is read whole
// before any of it is written).
template <int C, typename T, typename Out>
__device__ __forceinline__ void layer_norm_rows(const float* src, int lds,
                                                int rows, const T* w,
                                                const T* b, float eps,
                                                bool std_form, Out out) {
  constexpr int PER = C / 32;
  const int lane = threadIdx.x & 31;
  const int nwarp = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarp) {
    float v[PER];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = src[r * lds + lane + 32 * i];
      s += v[i];
    }
    const float mean = warp_sum(s) * (1.0f / C);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] -= mean;
      q += v[i] * v[i];
    }
    q = warp_sum(q);
    __syncwarp();
    if (std_form) {
      const float inv = 1.0f / (sqrtf(q / (C - 1)) + eps);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        out(r, c, ld(w + c) * v[i] * inv + ld(b + c));
      }
    } else {
      const float inv = rsqrtf(q * (1.0f / C) + eps);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        out(r, c, v[i] * inv * ld(w + c) + ld(b + c));
      }
    }
  }
}

}  // namespace gator
