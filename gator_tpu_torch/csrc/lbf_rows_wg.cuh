// K2's row-local launch in bf16, written for Hopper: a persistent kernel
// whose CTA holds a layer's weights in shared memory for its whole run and
// whose warpgroups take 64-row tiles through every product as `wgmma`.
//
// Replaces the row part of gator_tpu/nn/pallas_mdr.py:352 `lbf_stack_fused`
// (kernel body `_kernel_stack:256`), for bf16; f32 (3xTF32), K2-layer and
// T1 keep lbf_layer.cuh's `rows_kernel`. Per (sample, 64-row tile), as that
// kernel computes it under T1's policy (products and bias adds in f32,
// operands rounded to bf16 where they enter a product, the cross
// probabilities rounded, exact erff, an f32 residual):
//   x1 = x + Proj(CrossAttn(LN1(x) -> LN1(joints)))     (J joint keys)
//   x2 = x1 + MLP(LN2(x1))                              (exact GELU, 256)
//   y3 = StdLN(x2)       -> y3 (f32), q2, k2, v2 = T(y3 @ L0/L1/L2 + b)
//
// What bounds it on the H100 (B = 2048, Nv = 431, J = 17, a layer): 51
// GFMA on the tensor cores (0.10 ms) against 0.79 GB of f32 x in, f32 y3
// and bf16 q2/k2/v2 out (0.24 ms), so the bytes; 226 M exact erff and the
// LayerNorms and softmax around them come on top. lbf_layer.cuh's CTA-wide
// kernel, which took this launch before (32-row tiles, 8 warps splitting
// each 32x64x64 mma.sync product, the 13 weight blocks of every tile
// through a two-slot cp.async ring, ~25 CTA-wide barriers a tile), takes
// 2.21 ms; ablated (measured on one H100 80GB HBM3 at 700 W, CUDA events):
// without its products 1.71, without its element-wise stages 1.34, with
// neither 0.99 ms. Its barriers and ring, not its arithmetic, set its time.
//
// Design.
//   - One CTA an SM. The 15 [64, 64] weight blocks a tile takes (wq, wk, wv,
//     proj, fc1's four column blocks, fc2's four row blocks, L0, L1, L2;
//     120 KB) are loaded once, transposed to K-major and 128-byte swizzled
//     as `wgmma` reads its B operand; the vectors (LayerNorms, biases) as
//     f32.
//   - WGS warpgroups a CTA, each on its own contiguous run of the B *
//     ceil(Nv / 64) (sample, tile) items: tiles stay within a sample (431 =
//     6 x 64 + 47, 4 % of the rows computed and dropped), so a warpgroup
//     makes a sample's joint K and V (LN1, then two products; 12 KB of its
//     own) once per sample it meets and no tile needs two samples' joints.
//     The warpgroups share nothing after the weights, so they never wait
//     for each other: one's element-wise stages run while another's
//     products run. The only CTA-wide barrier is the one after the
//     weights; a warpgroup syncs its four warps with a named barrier only
//     when a new sample's K and V are written.
//   - Every product is `wgmma` with A from registers: a thread holds two
//     rows of the tile in the accumulator layout (16 columns of each), so
//     the residual, the LayerNorms (a row's sum over the quad of threads
//     that hold it), the softmax over the J joints and the GELU work in
//     registers, and each result is rounded to bf16 in place to become the
//     next product's A operand, as FlashAttention-3 chains its products
//     (fc1's accumulator through GELU into fc2, 64 hidden units at a time;
//     fc2's product runs while the next fc1 block is issued, and each of
//     q2/k2/v2 is stored while the next projection runs). Nothing but the
//     weights and the joints' K/V goes through shared memory: a tile's x
//     rows come from global memory into registers, and y3, q2, k2, v2 leave
//     from registers (a quad writes a row's 32 or 16 contiguous bytes a
//     column block).
// Measured the same way: 0.83-0.86 ms a layer (2.6x faster; 3.5x the byte
// bound). Ablated: without GELU 0.62, without the products 0.75, without
// any element-wise stage 0.49, without the stores 0.66. Tried and dropped:
// the next tile's x prefetched into registers (spills at three warpgroups)
// or by cp.async into shared memory (0.88: its barriers), the bf16 outputs
// staged through shared memory for 16-byte stores (0.83, within 3 %), fc1
// in 32-column chunks pipelined against GELU (1.02). About 5,500 SASS
// instructions a tile a thread, over half of them GELU's erff: the
// element-wise work is what is left.
// Rows past the last vertex are computed from zero inputs and never
// written. bf16 products are exact in f32, so only the order of the f32
// sums differs from lbf_layer.cuh's kernel.
#pragma once

#include "lbf_layer.cuh"

namespace gator {
namespace lbf_wg {

// the layer's shapes, its packed weights' fields and the score scale are
// lbf_layer.cuh's
using lbf_layer::C;
using lbf_layer::D;
using lbf_layer::HID;
using lbf_layer::JMAX;
using lbf_layer::kScale;
constexpr int TM = 64;    // rows a tile (a wgmma's M)
constexpr int WG_THREADS = 128;

// warpgroups a CTA: three fit an SM's registers (168 a thread) without
// spilling; two measured 1.00 ms a layer, three 0.83-0.86, four (128
// registers, spilling) 0.85-0.99 (PERF.md)
constexpr int WGS = 3;

// the resident weight blocks, each [64 out, 64 in] K-major, swizzled
enum Block { B_WQ, B_WK, B_WV, B_PROJ, B_FC1, B_FC2 = B_FC1 + 4,
             B_L0 = B_FC2 + 4, NBLK = B_L0 + 3 };
// the resident vectors, f32, at these offsets (floats)
enum Vec { V_LN1W = 0, V_LN1B = 64, V_PROJB = 128, V_LN2W = 192,
           V_LN2B = 256, V_FC1B = 320, V_FC2B = 576, V_A2 = 640,
           V_B2 = 704, V_L0B = 768, NVEC = V_L0B + 3 * 64 };

// Shared memory, in bytes from a 1024-aligned base: the blocks, then each
// warpgroup's joint keys KJ [32 joints, 64] and transposed values VJ [64,
// 64 joints (32 used)], swizzled like the blocks, then the vectors.
struct Smem {
  static constexpr int BLK = C * C * 2;  // 8 KB
  static constexpr int W = 0;
  static constexpr int KJ_BYTES = JMAX * C * 2, VJ_BYTES = BLK;
  static constexpr int PER_WG = KJ_BYTES + VJ_BYTES;
  static constexpr int JOINTS = W + NBLK * BLK;
  static constexpr int VEC = JOINTS + WGS * PER_WG;
  static constexpr int BYTES = VEC + NVEC * 4 + 1024;  // + the alignment
  static_assert(KJ_BYTES % 1024 == 0 && PER_WG % 1024 == 0,
                "swizzled tiles start on 1024 bytes");
};

// ---- wgmma --------------------------------------------------------------

// The descriptor of a K-major bf16 operand in shared memory: rows of 64
// elements (128 bytes), 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)), 8-row groups 1024 bytes apart, the tile on 1024 bytes. A
// k-step of 16 elements advances the start address by 32 bytes (+2).
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = tc::smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of element (r, k) in such a tile
__device__ __forceinline__ int swz(int r, int k) {
  return r * 128 + ((((k >> 3) ^ r) & 7) << 4) + (k & 7) * 2;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's committed groups are pending (the
// older ones complete first)
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading an accumulator before the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a @ B: m64n64k16, A (bf16) from registers, B by descriptor
__device__ __forceinline__ void mma_n64(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (+)= a @ B: m64n32k16
__device__ __forceinline__ void mma_n32(float (&d)[16],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---- a tile in registers ------------------------------------------------
// A thread of warp w (of its warpgroup), lane 4g + t, holds rows 16w + g
// and 16w + g + 8 of the tile: v[4j + e] is row (e < 2 ? 16w + g : 16w + g
// + 8), column 8j + 2t + (e & 1), the wgmma accumulator's layout.

__device__ __forceinline__ int col_of(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// The A operands of the k-steps over v's NV / 2 columns, rounded to bf16,
// into a[k0], a[k0 + 1], ...: the accumulator's layout is the register A
// operand's
template <int NV, int KA>
__device__ __forceinline__ void to_a(const float (&v)[NV],
                                     uint32_t (&a)[KA][4], int k0 = 0) {
#pragma unroll
  for (int ks = 0; ks < NV / 8; ++ks) {
    const int i = 8 * ks;
    a[k0 + ks][0] = tc::pack_bf16(v[i], v[i + 1]);
    a[k0 + ks][1] = tc::pack_bf16(v[i + 2], v[i + 3]);
    a[k0 + ks][2] = tc::pack_bf16(v[i + 4], v[i + 5]);
    a[k0 + ks][3] = tc::pack_bf16(v[i + 6], v[i + 7]);
  }
}

// LayerNorm of both rows, in place, as layer_norm_rows (common.cuh) forms
// it: std_form false (x - mean) * rsqrt(var + eps) * w + b; true
// w * (x - mean) / (n-1 std + eps) + b
template <bool kStd>
__device__ __forceinline__ void layer_norm(float (&v)[32], const float* w,
                                           const float* b, float eps) {
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 32; ++i) s[(i >> 1) & 1] += v[i];
  float mean[2], q[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h] = attn::quad_sum(s[h]) * (1.0f / C);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    v[i] -= mean[(i >> 1) & 1];
    q[(i >> 1) & 1] += v[i] * v[i];
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q[h] = attn::quad_sum(q[h]);
    inv[h] = kStd ? 1.0f / (sqrtf(q[h] / (C - 1)) + eps)
                  : rsqrtf(q[h] * (1.0f / C) + eps);
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int c = col_of(i);
    const float2 wc = ld2(w + c), bc = ld2(b + c);
    const float iv = inv[(i >> 1) & 1];
    if (kStd) {
      v[i] = wc.x * v[i] * iv + bc.x;
      v[i + 1] = wc.y * v[i + 1] * iv + bc.y;
    } else {
      v[i] = v[i] * iv * wc.x + bc.x;
      v[i + 1] = v[i + 1] * iv * wc.y + bc.y;
    }
  }
}

// d (+)= a @ (the [64, 64] block at blk): four k-steps as one group, not
// waited for; a and d are the product's until it completes
__device__ __forceinline__ void issue64(float (&d)[32],
                                        const uint32_t (&a)[4][4],
                                        const unsigned char* blk, bool add) {
  const uint64_t b = desc(blk);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) mma_n64(d, a[ks], b + 2 * ks, add || ks);
  wg_commit();
}

// d = a @ (the block at blk), waited for
__device__ __forceinline__ void gemm64(float (&d)[32],
                                       const uint32_t (&a)[4][4],
                                       const unsigned char* blk) {
  issue64(d, a, blk, false);
  wg_wait<0>();
  fence_regs(d);
}

// ---- the kernel ---------------------------------------------------------

struct Args {
  const float* x;             // [B, Nv, C] layer input
  const __nv_bfloat16* joints;  // [B, J, C]
  const __nv_bfloat16* p;     // packed weights of the layer
  const int* offs;            // field offsets
  float* y3;                  // [B, Nv, C]
  __nv_bfloat16* q2;          // [B, Nv, C]
  __nv_bfloat16* k2;
  __nv_bfloat16* v2;
  int B, Nv, J;
  int nrt;                    // row tiles a sample
};

// The weights of the layer into shared memory, by every thread of the
// CTA: block (field, r0, c0, ldw) as Wt[n][k] = W[r0 + k][c0 + n]
__device__ __forceinline__ void load_weights(const Args& a,
                                             unsigned char* sm) {
  using namespace lbf_layer;  // the field names
  const __nv_bfloat16* p = a.p;
  const int* o = a.offs;
  for (int i = threadIdx.x; i < NBLK * C * 8; i += blockDim.x) {
    const int blk = i / (C * 8), k = i % (C * 8) / 8, q = i % 8;
    int field, r0 = 0, c0 = 0, ldw = C;
    if (blk < B_FC1) {
      constexpr int F[4] = {WQ, WK, WV, PROJ_W};
      field = F[blk];
    } else if (blk < B_FC2) {
      field = FC1_W;
      c0 = (blk - B_FC1) * C;
      ldw = HID;
    } else if (blk < B_L0) {
      field = FC2_W;
      r0 = (blk - B_FC2) * C;
    } else {
      field = L0_W + 2 * (blk - B_L0);
    }
    const uint4 v = *reinterpret_cast<const uint4*>(
        p + o[field] + (size_t)(r0 + k) * ldw + c0 + 8 * q);
    const unsigned short* e = reinterpret_cast<const unsigned short*>(&v);
    unsigned char* dst = sm + Smem::W + blk * Smem::BLK;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<unsigned short*>(dst + swz(8 * q + n, k)) = e[n];
  }
  float* vec = at<float>(sm, Smem::VEC);
  for (int i = threadIdx.x; i < NVEC; i += blockDim.x) {
    int field, c;
    if (i < V_FC1B) {
      constexpr int F[5] = {LN1_W, LN1_B, PROJ_B, LN2_W, LN2_B};
      field = F[i / C];
      c = i % C;
    } else if (i < V_FC2B) {
      field = FC1_B;
      c = i - V_FC1B;
    } else {
      constexpr int F[6] = {FC2_B, A2, B2, L0_B, L1_B, L2_B};
      field = F[(i - V_FC2B) / C];
      c = (i - V_FC2B) % C;
    }
    vec[i] = __bfloat162float(p[o[field] + c]);
  }
}

// A warpgroup's own barrier (ids 1.., 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS)
               : "memory");
}

// generic-proxy writes to shared memory, before wgmma reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The rows of this thread (r < nr) of a tile starting at global row
// `row0`, f32 into v (zero past nr)
__device__ __forceinline__ void load_x(float (&v)[32], const float* x,
                                       size_t row0, int nr, int ra) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const float* src = x + (row0 + r) * C;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 f = r < nr ? __ldg(reinterpret_cast<const float2*>(
                                    src + col_of(4 * j)))
                              : make_float2(0.0f, 0.0f);
      v[4 * j + 2 * h] = f.x;
      v[4 * j + 2 * h + 1] = f.y;
    }
  }
}

// Sample b's joints: LN1, rounded (rows J.. zero), then K into KJ and V
// into VJ (transposed), both rounded, for this warpgroup's products
__device__ __forceinline__ void joints_kv(const Args& a, unsigned char* sm,
                                          unsigned char* kj,
                                          unsigned char* vj, int b, int ra,
                                          int wg) {
  const float* vec = at<float>(sm, Smem::VEC);
  float v[32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const __nv_bfloat16* src = a.joints + ((size_t)b * a.J + r) * C;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 f = r < a.J ? ld2(src + col_of(4 * j))
                               : make_float2(0.0f, 0.0f);
      v[4 * j + 2 * h] = f.x;
      v[4 * j + 2 * h + 1] = f.y;
    }
  }
  layer_norm<false>(v, vec + V_LN1W, vec + V_LN1B, 1e-5f);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (ra + 8 * ((i >> 1) & 1) >= a.J) v[i] = 0.0f;
  uint32_t y[4][4];
  to_a(v, y);
  wg_sync(wg);  // every warp is done with the previous sample's KJ, VJ
  float d[32];
  gemm64(d, y, sm + Smem::W + B_WK * Smem::BLK);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = ra + 8 * ((i >> 1) & 1);
    if (r < JMAX)
      *reinterpret_cast<uint32_t*>(kj + swz(r, col_of(i))) =
          tc::pack_bf16(d[i], d[i + 1]);
  }
  gemm64(d, y, sm + Smem::W + B_WV * Smem::BLK);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = ra + 8 * ((i >> 1) & 1);
    if (r < JMAX)
      *reinterpret_cast<__nv_bfloat16*>(vj + swz(col_of(i), r)) =
          __float2bfloat16(d[i]);
  }
  fence_async_smem();
  wg_sync(wg);
}

// x: f32 [B, Nv, C]; joints: bf16 [B, J, C]. Writes y3 (f32) and q2, k2,
// v2 (bf16 [B, Nv, C]). One CTA an SM, WGS warpgroups a CTA, each on a
// contiguous run of the B * nrt (sample, 64-row tile) items.
__global__ void __launch_bounds__(WGS * WG_THREADS, 1)
    rows_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* sm =
      raw + ((1024 - (tc::smem_addr(raw) & 1023)) & 1023);
  load_weights(a, sm);
  fence_async_smem();
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  const int ra = (threadIdx.x % WG_THREADS) / 32 * 16 + (threadIdx.x & 31) / 4;
  const long long total = (long long)a.B * a.nrt;
  const long long workers = (long long)gridDim.x * WGS;
  const long long w = (long long)blockIdx.x * WGS + wg;
  const long long beg = total * w / workers, end = total * (w + 1) / workers;
  if (beg >= end) return;

  const float* vec = at<float>(sm, Smem::VEC);
  unsigned char* kj = sm + Smem::JOINTS + wg * Smem::PER_WG;
  unsigned char* vj = kj + Smem::KJ_BYTES;
  const unsigned char* wblk = sm + Smem::W;
  const int J = a.J, Nv = a.Nv;
  int jb = -1;
  float x[32];
  auto tile_rows = [&](long long t, size_t& row0) {
    const int b = (int)(t / a.nrt), r0 = (int)(t % a.nrt) * TM;
    row0 = (size_t)b * Nv + r0;
    return min(TM, Nv - r0);
  };
  {
    size_t row0;
    const int nr = tile_rows(beg, row0);
    load_x(x, a.x, row0, nr, ra);
  }
  for (long long t = beg; t < end; ++t) {
    const int b = (int)(t / a.nrt);
    size_t row0;
    const int nr = tile_rows(t, row0);
    if (b != jb) {
      jb = b;
      joints_kv(a, sm, kj, vj, b, ra, wg);
    }

    float v[32], d[32];
    uint32_t af[4][4];
    // q = T(T(LN1 x) @ wq)
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = x[i];
    layer_norm<false>(v, vec + V_LN1W, vec + V_LN1B, 1e-5f);
    to_a(v, af);
    gemm64(d, af, wblk + B_WQ * Smem::BLK);
    to_a(d, af);  // af[2h + k]: head h's q, k-step k
    {
      // scores per head over the J joints (padded to 32), the softmax per
      // row rounded to bf16, then o = T(P @ V)
      float s[2][16];
      const uint64_t dk = desc(kj);
      wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          mma_n32(s[h], af[2 * h + k], dk + 4 * h + 2 * k, k);
      wg_commit();
      wg_wait<0>();
      fence_regs(s[0]);
      fence_regs(s[1]);
      uint32_t pf[2][2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          s[h][i] = col_of(i) < J ? s[h][i] * kScale : -CUDART_INF_F;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[h][i]);
        }
        float l[2] = {0.0f, 0.0f};
#pragma unroll
        for (int e = 0; e < 2; ++e) mx[e] = attn::quad_max(mx[e]);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          s[h][i] = col_of(i) < J ? expf(s[h][i] - mx[(i >> 1) & 1]) : 0.0f;
          l[(i >> 1) & 1] += s[h][i];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) l[e] = attn::quad_sum(l[e]);
#pragma unroll
        for (int i = 0; i < 16; ++i) s[h][i] = s[h][i] / l[(i >> 1) & 1];
        to_a(s[h], pf[h]);
      }
      const uint64_t dv = desc(vj);
      wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          mma_n32(s[h], pf[h][k], dv + (h * D * 128 >> 4) + 2 * k, k);
      wg_commit();
      wg_wait<0>();
      fence_regs(s[0]);
      fence_regs(s[1]);
      to_a(s[0], af, 0);  // o's columns 0..31 (head 0), then head 1's
      to_a(s[1], af, 2);
    }
    // x1 = x + (o @ Wproj + b)
    gemm64(d, af, wblk + B_PROJ * Smem::BLK);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 bc = ld2(vec + V_PROJB + col_of(i));
      x[i] += d[i] + bc.x;
      x[i + 1] += d[i + 1] + bc.y;
    }
    // x2 = x1 + fc2(gelu(fc1(T(LN2 x1)))), 64 hidden units at a time
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = x[i];
    layer_norm<false>(v, vec + V_LN2W, vec + V_LN2B, 1e-5f);
    uint32_t yf[4][4];
    to_a(v, yf);
    // fc2's product of a block is left running while the next fc1 block
    // is issued: one wait covers both
#pragma unroll 1
    for (int nb = 0; nb < HID / C; ++nb) {
      gemm64(v, yf, wblk + (B_FC1 + nb) * Smem::BLK);
      fence_regs(d);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 bc = ld2(vec + V_FC1B + nb * C + col_of(i));
        v[i] = gelu_exact(v[i] + bc.x);
        v[i + 1] = gelu_exact(v[i + 1] + bc.y);
      }
      to_a(v, af);
      issue64(d, af, wblk + (B_FC2 + nb) * Smem::BLK, nb > 0);
    }
    wg_wait<0>();
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 bc = ld2(vec + V_FC2B + col_of(i));
      x[i] += d[i] + bc.x;
      x[i + 1] += d[i + 1] + bc.y;
    }
    // y3 = StdLN(x2), f32 out and rounded for L0/L1/L2
    layer_norm<true>(x, vec + V_A2, vec + V_B2, 1e-6f);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = ra + 8 * ((i >> 1) & 1);
      if (r < nr) st2(a.y3 + (row0 + r) * C + col_of(i), x[i], x[i + 1]);
    }
    to_a(x, yf);
    // q2, k2, v2 = T(y3 @ L + b): each store runs beside the next product
    auto store = [&](float (&o)[32], int l) {
      const float* lb = vec + V_L0B + l * C;
      __nv_bfloat16* out = l == 0 ? a.q2 : (l == 1 ? a.k2 : a.v2);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = ra + 8 * ((i >> 1) & 1);
        const float2 bc = ld2(lb + col_of(i));
        if (r < nr)
          st2(out + (row0 + r) * C + col_of(i), o[i] + bc.x,
              o[i + 1] + bc.y);
      }
    };
    issue64(d, yf, wblk + B_L0 * Smem::BLK, false);
    issue64(v, yf, wblk + (B_L0 + 1) * Smem::BLK, false);
    wg_wait<1>();
    fence_regs(d);
    store(d, 0);
    issue64(d, yf, wblk + (B_L0 + 2) * Smem::BLK, false);
    wg_wait<1>();
    fence_regs(v);
    store(v, 1);
    wg_wait<0>();
    fence_regs(d);
    store(d, 2);
    if (t + 1 < end) {
      size_t row1;
      const int nr1 = tile_rows(t + 1, row1);
      load_x(x, a.x, row1, nr1, ra);
    }
  }
}

inline int launch_rows(const void* x, const void* joints, const void* weights,
                       const void* offs, void* y3, void* q2, void* k2,
                       void* v2, int B, int Nv, int J, cudaStream_t stream) {
  const int smem = Smem::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the SMs of the device this launch runs on
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const Args a{static_cast<const float*>(x),
               static_cast<const __nv_bfloat16*>(joints),
               static_cast<const __nv_bfloat16*>(weights),
               static_cast<const int*>(offs), static_cast<float*>(y3),
               static_cast<__nv_bfloat16*>(q2),
               static_cast<__nv_bfloat16*>(k2),
               static_cast<__nv_bfloat16*>(v2), B, Nv, J,
               (Nv + TM - 1) / TM};
  const long long total = (long long)B * a.nrt;
  if (total == 0) return 0;
  // one CTA an SM, no more than the warpgroups' runs need
  const long long need = (total + WGS - 1) / WGS;
  rows_kernel<<<(int)(need < sms ? need : sms), WGS * WG_THREADS, smem,
                stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch's plan: rows[0] CTAs resident an SM, [1] rows a tile, [2]
// shared-memory bytes, [3] registers a thread, [4] warpgroups a CTA.
// Returns a cudaError_t.
inline int plan(int* rows) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, rows_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &rows[0], rows_kernel, WGS * WG_THREADS, Smem::BYTES);
  rows[1] = TM;
  rows[2] = Smem::BYTES;
  rows[3] = err == cudaSuccess ? attr.numRegs : 0;
  rows[4] = WGS;
  return (int)err;
}

}  // namespace lbf_wg
}  // namespace gator
