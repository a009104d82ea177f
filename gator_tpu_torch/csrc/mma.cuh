// Tensor-core building blocks shared by K3 (fused_attention.cu and
// attn_tc.cuh), K4's row-local launches (lbf_stack_train.cu) and K2's two
// launches (lbf_stack.cu, lbf_layer.cuh): warp-level mma.sync, ldmatrix,
// cp.async, and a block-level product over operands in shared memory.
//
// Numerics. bf16: operands are rounded to bf16 (round to nearest even, as
// `rnd<bf16>`) and each m16n8k16 product accumulates in f32; a product of
// two bf16 values is exact in f32, so the products equal an FMA chain's and
// only the order of the sums differs. f32: the "3xTF32" split. Each operand
// x is cut into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, round to
// nearest, ties away) and a*b is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
// in three m16n8k8 TF32 products into one f32 accumulator. The dropped
// lo_a*lo_b term is below 2^-22 of the product, so the result keeps about
// f32 accuracy; a single TF32 product keeps about three decimal digits and
// is never used.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gator {
namespace tc {

// d += a * b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b, m16n8k8, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ what neither keeps)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// two values as bf16 in one register, `lo` in the low half (the element of
// the lower index in every mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: thread i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, asynchronously; both addresses
// 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` rows of `cols` elements of E (cols * sizeof(E) a multiple of
// 16 bytes; src rows `lds` elements apart, dst rows `ldd`) into shared
// memory with cp.async, all threads of the block; the caller commits and
// waits.
template <typename E>
__device__ __forceinline__ void stage(E* dst, int ldd, const E* src, int lds,
                                      int rows, int cols) {
  constexpr int V = 16 / sizeof(E);
  const int per = cols / V;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, c = i % per * V;
    cp_async16(dst + r * ldd + c, src + (size_t)r * lds + c);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// How an operand accessor F lays out bf16 elements in shared memory, so
// that fragments load whole: kRowMajor, element (i, j) at p + i * ld + j
// (`F::ptr(i, j)`, rows 16-byte aligned); kColMajor, at p + j * ld + i.
// Other accessors (kNone) are read element by element.
enum Layout { kNone, kRowMajor, kColMajor };

template <class F, class = void>
struct LayoutOf {
  static constexpr Layout value = kNone;
};
template <class F>
struct LayoutOf<F, decltype(void(F::kLayout))> {
  static constexpr Layout value = F::kLayout;
};

// element (i, j) of a row-major (RowMajor) or column-major (ColMajor)
// buffer of E in shared memory as f32: an mma operand accessor (`gemm`),
// whose fragments load whole in bf16 (ld even, rows 16-byte aligned)
template <typename E>
struct RowMajor {
  static constexpr Layout kLayout =
      sizeof(E) == 2 ? kRowMajor : kNone;
  const E* p;
  int ld;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return Num<E>::to_float(p[i * ld + j]);
  }
  __device__ __forceinline__ const E* ptr(int i, int j) const {
    return p + i * ld + j;
  }
};

template <typename E>
struct ColMajor {
  static constexpr Layout kLayout =
      sizeof(E) == 2 ? kColMajor : kNone;
  const E* p;
  int ld;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return Num<E>::to_float(p[j * ld + i]);
  }
  __device__ __forceinline__ const E* ptr(int i, int j) const {
    return p + j * ld + i;
  }
};

// The fragments of one mma step for the working type T, loaded through
// element accessors a(m, k) and b(k, n) that return f32 values.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int KS = 16;  // depth of one step
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  template <class F>
  static __device__ __forceinline__ A load_a(F f, int m0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    A a;
    constexpr Layout L = LayoutOf<F>::value;
    if constexpr (L == kRowMajor) {  // k pairs side by side
      a.r[0] = *reinterpret_cast<const uint32_t*>(f.ptr(m0 + g, k0 + 2 * t));
      a.r[1] =
          *reinterpret_cast<const uint32_t*>(f.ptr(m0 + g + 8, k0 + 2 * t));
      a.r[2] =
          *reinterpret_cast<const uint32_t*>(f.ptr(m0 + g, k0 + 2 * t + 8));
      a.r[3] = *reinterpret_cast<const uint32_t*>(
          f.ptr(m0 + g + 8, k0 + 2 * t + 8));
    } else if constexpr (L == kColMajor) {  // four 8x8 blocks, transposed
      const int lane = threadIdx.x & 31, q = lane >> 3;
      ldsm_x4_trans(a.r,
                    f.ptr(m0 + (q & 1) * 8, k0 + (q >> 1) * 8 + (lane & 7)));
    } else {
      a.r[0] = pack_bf16(f(m0 + g, k0 + 2 * t), f(m0 + g, k0 + 2 * t + 1));
      a.r[1] = pack_bf16(f(m0 + g + 8, k0 + 2 * t),
                         f(m0 + g + 8, k0 + 2 * t + 1));
      a.r[2] = pack_bf16(f(m0 + g, k0 + 2 * t + 8), f(m0 + g, k0 + 2 * t + 9));
      a.r[3] = pack_bf16(f(m0 + g + 8, k0 + 2 * t + 8),
                         f(m0 + g + 8, k0 + 2 * t + 9));
    }
    return a;
  }
  template <class F>
  static __device__ __forceinline__ B load_b(F f, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    B b;
    constexpr Layout L = LayoutOf<F>::value;
    if constexpr (L == kColMajor) {  // k pairs side by side
      b.r[0] = *reinterpret_cast<const uint32_t*>(f.ptr(k0 + 2 * t, n0 + g));
      b.r[1] =
          *reinterpret_cast<const uint32_t*>(f.ptr(k0 + 2 * t + 8, n0 + g));
    } else if constexpr (L == kRowMajor) {  // two 8x8 blocks, transposed
      ldsm_x2_trans(b.r, f.ptr(k0 + (threadIdx.x & 15), n0));
    } else {
      b.r[0] = pack_bf16(f(k0 + 2 * t, n0 + g), f(k0 + 2 * t + 1, n0 + g));
      b.r[1] = pack_bf16(f(k0 + 2 * t + 8, n0 + g), f(k0 + 2 * t + 9, n0 + g));
    }
    return b;
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_bf16(d, a.r, b.r);
  }
};

template <>
struct Mma<float> {
  static constexpr int KS = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  template <class F>
  static __device__ __forceinline__ A load_a(F f, int m0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    A a;
    split_tf32(f(m0 + g, k0 + t), a.hi[0], a.lo[0]);
    split_tf32(f(m0 + g + 8, k0 + t), a.hi[1], a.lo[1]);
    split_tf32(f(m0 + g, k0 + t + 4), a.hi[2], a.lo[2]);
    split_tf32(f(m0 + g + 8, k0 + t + 4), a.hi[3], a.lo[3]);
    return a;
  }
  template <class F>
  static __device__ __forceinline__ B load_b(F f, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    B b;
    split_tf32(f(k0 + t, n0 + g), b.hi[0], b.lo[0]);
    split_tf32(f(k0 + t + 4, n0 + g), b.hi[1], b.lo[1]);
    return b;
  }
  // the small terms first, then the large one
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
  }
};

// out(m, n, sum_k a(m, k) * b(k, n)) for m < 16 * mt, n < 8 * nt, on the
// tensor cores of every warp of the block: a warp owns one 16-row tile
// against NB 8-column tiles (nt % NB == 0) and walks k in steps of
// Mma<T>::KS (K a multiple of it). a and b return f32 values, which the
// fragments round to T (bf16) or split (f32). Each (m, n) is passed to
// `out` once, by one thread; the sum over k runs in a fixed order. An
// `out` that takes (m, n, v, w) gets columns n (even) and n + 1 together.
template <typename T, int NB, class FA, class FB, class Out>
__device__ __forceinline__ void gemm(int mt, int nt, int K, FA a, FB b,
                                     Out out) {
  using P = Mma<T>;
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int ng = nt / NB;
  for (int item = warp; item < mt * ng; item += nwarp) {
    const int m0 = item / ng * 16, n0 = item % ng * NB * 8;
    float acc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += P::KS) {
      const typename P::A fa = P::load_a(a, m0, k0);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        P::mma(acc[j], fa, P::load_b(b, k0, n0 + 8 * j));
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if constexpr (std::is_invocable_v<Out, int, int, float, float>) {
        out(m0 + g, n, acc[j][0], acc[j][1]);
        out(m0 + g + 8, n, acc[j][2], acc[j][3]);
      } else {
        out(m0 + g, n, acc[j][0]);
        out(m0 + g, n + 1, acc[j][1]);
        out(m0 + g + 8, n, acc[j][2]);
        out(m0 + g + 8, n + 1, acc[j][3]);
      }
    }
  }
}

}  // namespace tc
}  // namespace gator
