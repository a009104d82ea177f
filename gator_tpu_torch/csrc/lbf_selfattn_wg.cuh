// K2's self-attention launch in bf16, written for Hopper: each score and
// each exponential computed once, the key row of a query tile held in the
// registers of four warpgroups, every product a `wgmma`.
//
// Replaces the self-attention of gator_tpu/nn/pallas_mdr.py:352
// `lbf_stack_fused` (kernel body `_kernel_stack:256`), for bf16 key rows of
// up to NV_WG keys; f32, and longer rows, keep lbf_stack.cu's two-pass
// `lbf_selfattn_kernel` on attn_tc.cuh. Per layer and head, with y3 and
// q2/k2/v2 from the rows launch, under the TPU kernel's numerics
// (pallas_mdr.py:342): scores and softmax in f32, the max taken over the
// whole row before any exponential, the normalised probabilities rounded to
// bf16 before PV, PV in f32 rounded to bf16 before L3, the residual in f32:
//   x' = y3 + bf16(bf16(softmax(q k^T / sqrt(32))) v) @ L3 + l3_b
//
// What bounds it on the H100 (B = 2048, Nv = 431, 2 heads of D = 32, a
// layer): 2048 x 2 x 431 x 431 = 761 M scores, each one exponential: 0.195
// ms at the special-function units' ~3.9 T/s (FlashAttention-3's figure for
// the H100). The bytes, q2/k2/v2 in bf16 and y3 in, x' out in f32, are 0.79
// GB (0.24 ms at 3.35 TB/s); the products 52 GFMA (0.11 ms at 989 TFLOP/s).
// At D = 32 a score carries 128 FLOP of product, half the ~250 that would
// balance one exponential against the tensor cores, so the exponentials and
// the f32 element work around them (scale, max, subtract, sum, normalise,
// round), not the products, set the time. The two-pass kernel computes
// every score and its exponential twice (pass 1 for the online max and sum,
// pass 2 again for the normalised probabilities), and stages K in two
// chunks behind a full wait each pass: 1.40 ms a layer (PERF.md).
//
// Design. A normalised probability can be rounded only once the row's final
// max and sum are known; so the whole key row of a query tile stays in
// registers, cut across warpgroups, and the max and the sum cross them
// through shared memory:
//   - One persistent CTA an SM of four warpgroups. The CTA walks a
//     contiguous run of the B * ceil(Nv / 64) (sample, 64-row query tile)
//     items; within a sample it takes head 0 over its tiles, then head 1
//     over the same tiles. A (sample, head) is a stage: the head's K and V
//     rows (64 bytes each) come into one of two slots by cp.async, 64-byte
//     swizzled as `wgmma` reads them, while the previous stage computes.
//     Warpgroups 1-3 issue the K/V copies and wait for them only before a
//     stage's first tile; warpgroup 0 issues the query tile two tiles ahead
//     and each head-1 tile's y3, and waits for them once a tile. cp.async
//     groups are per thread, so neither stream waits for the other's copies.
//   - Warpgroup w owns keys [112 w, 112 w + 112) of the 448 (NV_WG) a row
//     holds: S = Q K^T is one m64n112k16 `wgmma` a k-step, 56 f32
//     accumulators a thread (keys past Nv masked to -inf). Each row's max
//     over the four warpgroups, then one exp2f a score against it, then the
//     sum the same way (summed in warpgroup order).
//   - p = bf16(e / sum) becomes the A operand of PV in registers: seven
//     m64n32k16 `wgmma` over the warpgroup's keys, V read MN-major. The four
//     f32 partial o tiles meet in shared memory, each warpgroup sums a
//     quarter in warpgroup order and rounds it to bf16.
//   - Head 0's rounded o waits in shared memory (every row of the sample).
//     A head-1 tile's epilogue runs in the next tile, beside its
//     exponentials: both heads' o as the A operand of x' = y3 + o @ L3 +
//     l3_b, m64n16k16 a warpgroup (16 of the 64 columns), L3 resident
//     (K-major, 128-byte swizzle), y3 staged by warpgroup 0.
// Measured (one H100 80GB HBM3 at 700 W, three layers at B = 2048 on the
// serving path's rows output, CUDA events): 0.79-0.81 ms a layer, against
// the two-pass kernel's 1.39-1.42 in the same runs. A tile takes ~6,800
// cycles (clock64 stamps): the row max 700, the exponentials 2,400 (the
// units' floor 1,792) and the last epilogue ~600, PV with p's
// normalisation 1,300-1,500, the partial tiles and the next S 600, their
// sum 500. All sixteen warps are in one phase at a time, so the tensor
// cores, the special-function units and the ALUs take turns; a second
// tile's 28,672 f32 scores do not fit beside the first in the register
// file. ptxas serializes the kernel's `wgmma` because the epilogue's
// product sits under a branch (after head-1 tiles only); running it after
// every tile lifts that, and measured slower.
// Only the order of f32 sums differs from the two-pass kernel (the
// exponential sum, PV, L3's sum), so a rare bf16 rounding of a p or an o
// flips. Q rows past the sample's last read its last row and are never
// written; K and V rows past it stay zero.
#pragma once

#include "lbf_rows_wg.cuh"

namespace gator {
namespace lbf_sa_wg {

using lbf_layer::C;
using lbf_layer::D;
using lbf_layer::kScale;
using lbf_wg::WG_THREADS;
constexpr int TM = 64;                 // query rows a tile
constexpr int WGS = 4;                 // warpgroups a CTA
constexpr int KW = 112;                // keys a warpgroup
constexpr int NV_WG = WGS * KW;        // the longest key row the kernel holds
constexpr int THREADS = WGS * WG_THREADS;
constexpr int NS = KW / 2;             // score accumulators a thread
constexpr int NO = D / 2;              // o accumulators a thread

// Shared memory, in bytes from a 1024-aligned base. A head's rows are 64
// bytes (D bf16), 64-byte swizzled in 512-byte groups of 8 rows.
struct Smem {
  static constexpr int ROW = D * 2;
  static constexpr int HEAD = NV_WG * ROW;  // K or V of one head, 28 KB
  static constexpr int SLOT = 2 * HEAD;     // K, then V
  static constexpr int QT = TM * ROW;       // a query tile
  static constexpr int KV = 0;              // two slots
  static constexpr int Q = KV + 2 * SLOT;   // two query tiles
  static constexpr int W3 = Q + 2 * QT;     // L3 [64 out][64 in], 128B swizzle
  static constexpr int O0 = W3 + C * C * 2; // head 0's bf16 o, sample's rows
  static constexpr int O1 = O0 + HEAD;      // head 1's bf16 o, one tile
  static constexpr int PART = O1 + QT;      // the warpgroups' f32 partial o
  static constexpr int PART_WG = NO * WG_THREADS * 4;
  static constexpr int MAX = PART + WGS * PART_WG;  // [WGS][TM] f32
  static constexpr int SUM = MAX + WGS * TM * 4;    // [WGS][TM] f32
  static constexpr int Y3 = SUM + WGS * TM * 4;     // y3 [TM][C] f32, swizzled
  static constexpr int BYTES = Y3 + TM * C * 4 + 1024;  // + the alignment
  static_assert(SLOT % 1024 == 0 && W3 % 1024 == 0 && O0 % 512 == 0 &&
                    O1 % 512 == 0 && Y3 % 16 == 0,
                "swizzled tiles start on their swizzle's period");
  static_assert(BYTES <= 227 * 1024, "one CTA an SM");
};

// byte offset of 16-byte chunk c of row r in a 64-byte-swizzled tile
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + (((c ^ (r >> 1)) & 3) << 4);
}

// The descriptor of such a tile: 8-row groups 512 bytes apart. As a K-major
// operand a k-step of 16 elements advances the start by 32 bytes (+2); as
// an MN-major one (V) by 16 rows, 1024 bytes (+64).
__device__ __forceinline__ uint64_t desc64(const void* p) {
  const uint32_t a = tc::smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// d (+)= A @ B: m64n112k16, A and B K-major by descriptor
__device__ __forceinline__ void mma_qk(float (&d)[NS], uint64_t a, uint64_t b,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= a @ B: m64n32k16, A (bf16) from registers, B MN-major
__device__ __forceinline__ void mma_pv(float (&d)[NO], const uint32_t (&a)[4],
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (+)= a @ B: m64n16k16, A (bf16) from registers, B K-major
__device__ __forceinline__ void mma_l3(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ldmatrix of four 8x8 blocks: thread i gives the address of row i % 8 of
// block i / 8; as the A operand of a k-step, lanes 0-15 give rows 0-15 at
// the step's first 8 columns, lanes 16-31 at its next 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_addr(p)));
}

struct Args {
  const __nv_bfloat16* q2;  // [B, Nv, C], head h at columns [32 h, 32 h + 32)
  const __nv_bfloat16* k2;
  const __nv_bfloat16* v2;
  const float* y3;          // [B, Nv, C]
  const __nv_bfloat16* p;   // packed weights of the layer
  const int* offs;          // field offsets
  float* xout;              // [B, Nv, C]
  int B, Nv;
  int nqt;                  // query tiles a sample
};

// A place in the CTA's walk: query tile qt of head h of sample b, inside the
// run [qt0, qt1) of sample b's tiles that the CTA owns (empty past its run)
struct Pos {
  int b, qt, qt0, qt1, h;
};

// the run of sample b's tiles among the items [b nqt + qt0, kend)
__device__ __forceinline__ Pos run_at(int b, int qt0, int kend, int nqt) {
  return {b, qt0, qt0, min(nqt, kend - b * nqt), 0};
}

// the tile after p: the run's next tile, head 1 after head 0, then the
// next sample's run
__device__ __forceinline__ Pos next_tile(Pos p, int kend, int nqt) {
  if (p.qt + 1 < p.qt1) {
    ++p.qt;
  } else if (p.h == 0) {
    p.h = 1;
    p.qt = p.qt0;
  } else {
    p = run_at(p.b + 1, 0, kend, nqt);
  }
  return p;
}

// the first tile of the stage (sample, head) after p's
__device__ __forceinline__ Pos next_stage(Pos p, int kend, int nqt) {
  p.qt = p.qt1 - 1;
  return next_tile(p, kend, nqt);
}

// K and V of the head and sample of p, rows < Nv, into a slot: by the
// threads [0, n) of warpgroups 1-3 (i), uncommitted
__device__ __forceinline__ void load_kv(const Args& a, unsigned char* slot,
                                        const Pos& p, int i, int n) {
  const __nv_bfloat16* k = a.k2 + (size_t)p.b * a.Nv * C + p.h * D;
  const __nv_bfloat16* v = a.v2 + (size_t)p.b * a.Nv * C + p.h * D;
  for (int j = i; j < a.Nv * 8; j += n) {
    const int r = j >> 3, c = j & 3;
    tc::cp_async16(slot + (j & 4 ? Smem::HEAD : 0) + swz64(r, c),
                   (j & 4 ? v : k) + r * C + c * 8);
  }
}

// the query tile of p into dst, by warpgroup 0 (thread i: chunk i % 4 of
// rows i / 4 and i / 4 + 32), uncommitted; rows past the sample's last read
// its last row
__device__ __forceinline__ void load_q(const Args& a, unsigned char* dst,
                                       const Pos& p, int i) {
  const __nv_bfloat16* q = a.q2 + (size_t)p.b * a.Nv * C + p.h * D;
  const int c = i & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = (i >> 2) + 32 * u;
    tc::cp_async16(dst + swz64(r, c),
                   q + min(p.qt * TM + r, a.Nv - 1) * C + c * 8);
  }
}

// L3 into shared memory, Wt[n][k] = L3[k][n], K-major, 128-byte swizzle
__device__ __forceinline__ void load_l3(const Args& a, unsigned char* w3) {
  const __nv_bfloat16* l3 = a.p + a.offs[lbf_layer::L3_W];
  for (int i = threadIdx.x; i < C * 8; i += blockDim.x) {
    const int k = i / 8, q = i % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(l3 + k * C + 8 * q);
    const unsigned short* e = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<unsigned short*>(w3 + lbf_wg::swz(8 * q + n, k)) =
          e[n];
  }
}

// s = Q K^T over a warpgroup's keys: two k-steps, committed, not waited for
__device__ __forceinline__ void issue_qk(float (&s)[NS], const void* q,
                                         const void* k) {
  const uint64_t dq = desc64(q), dk = desc64(k);
  lbf_wg::wg_fence();
  mma_qk(s, dq, dk, 0);
  mma_qk(s, dq + 2, dk + 2, 1);
  lbf_wg::wg_commit();
}

// y3's rows [row0, row0 + nq) into Y3, by warpgroup 0 (thread i: chunk
// i % 16 of rows i / 16 + 8 u), uncommitted; rows past nq read the last
// one. Chunk c of row r sits at chunk c ^ (r % 8), so that the epilogue's
// reads of eight rows at one column meet no bank twice.
__device__ __forceinline__ void load_y3(const Args& a, unsigned char* dst,
                                        size_t row0, int nq, int i) {
  const int c = i & 15;
  const float* src = a.y3 + row0 * C + c * 4;
#pragma unroll
  for (int u = 0; u < TM / 8; ++u) {
    const int r = (i >> 4) + 8 * u;
    tc::cp_async16(dst + r * C * 4 + ((c ^ (r & 7)) << 4),
                   src + min(r, nq - 1) * C);
  }
}

// Head 1's epilogue of a tile whose rounded o (both heads) and y3 are in
// shared memory: x' = y3 + (o @ L3 + b), columns [16 wg, 16 wg + 16).
struct Epilogue {
  float d[8];
  // o (head 0 from the sample's rows, head 1 from O1) as the A operand, the
  // product issued and waited for
  __device__ __forceinline__ void product(unsigned char* sm, int qt, int wg,
                                          int lt) {
    const int lane = lt & 31;
    uint32_t af[4][4];
    const int r = lt / 32 * 16 + (lane & 15), c = lane >> 4;
    const unsigned char* o0 = sm + Smem::O0 + qt * Smem::QT;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      ldsm_x4(af[ks], o0 + swz64(r, 2 * ks + c));
      ldsm_x4(af[2 + ks], sm + Smem::O1 + swz64(r, 2 * ks + c));
    }
    const uint64_t dw = lbf_wg::desc(sm + Smem::W3 + wg * 16 * 128);
    lbf_wg::wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_l3(d, af[ks], dw + 2 * ks, ks);
    lbf_wg::wg_commit();
    lbf_wg::wg_wait<0>();
    lbf_wg::fence_regs(d);
  }
  // b: l3_b at columns 16 wg + 8 j + 2t, + 1
  __device__ __forceinline__ void store(const Args& a, unsigned char* sm,
                                        size_t row0, int nq, int wg, int lt,
                                        const float2 (&b)[2]) {
    const int lane = lt & 31, ra = lt / 32 * 16 + lane / 4, t = lane & 3;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = ra + 8 * e;
      if (row >= nq) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * wg + 8 * j + 2 * t;
        const float2 y = ld2(at<float>(
            sm, Smem::Y3 + row * C * 4 + (((col >> 2) ^ (row & 7)) << 4) +
                    (col & 3) * 4));
        st2(a.xout + (row0 + row) * C + col, y.x + d[4 * j + 2 * e] + b[j].x,
            y.y + d[4 * j + 2 * e + 1] + b[j].y);
      }
    }
  }
};

// One CTA an SM; see the header for the walk. Per tile the warpgroups meet
// at three barriers: each row's max, its sum, the partial o tiles. Between
// the first two the special-function units run the exponentials, beside
// the copies for later tiles and the last tile's epilogue; between the
// last two the tensor cores run PV; the next tile's S = Q K^T is issued
// before the third.
__global__ void __launch_bounds__(THREADS, 1)
    lbf_selfattn_kernel(const Args a) {
  using lbf_wg::fence_async_smem;
  using lbf_wg::fence_regs;
  using lbf_wg::wg_commit;
  using lbf_wg::wg_fence;
  using lbf_wg::wg_wait;
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* sm =
      raw + ((1024 - (tc::smem_addr(raw) & 1023)) & 1023);
  const int wg = threadIdx.x / WG_THREADS, lt = threadIdx.x % WG_THREADS;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int ra = lt / 32 * 16 + lane / 4;  // rows ra and ra + 8 of a tile
  const int total = a.B * a.nqt;
  const int kend = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  const int k0 = (int)((long long)total * blockIdx.x / gridDim.x);
  Pos cur = run_at(k0 / a.nqt, k0 % a.nqt, kend, a.nqt);

  // K/V rows past Nv stay zero: V's are multiplied by p = 0
  for (int i = threadIdx.x; i < 2 * Smem::SLOT / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(sm + Smem::KV)[i] = make_uint4(0, 0, 0, 0);
  load_l3(a, sm + Smem::W3);
  fence_async_smem();
  __syncthreads();
  // the first stage's K and V, the first two query tiles
  if (wg == 0) {
    const Pos p1 = next_tile(cur, kend, a.nqt);
    load_q(a, sm + Smem::Q, cur, lt);
    if (p1.qt < p1.qt1) load_q(a, sm + Smem::Q + Smem::QT, p1, lt);
  } else {
    load_kv(a, sm + Smem::KV, cur, threadIdx.x - WG_THREADS,
            THREADS - WG_THREADS);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  // this warpgroup's first key; past Nv its keys are masked, and a
  // warpgroup past every key still runs its products (on zero rows), so
  // that every `wgmma` is issued by all warpgroups alike
  const int kw0 = wg * KW;
  const bool ragged = kw0 + KW > a.Nv;
  constexpr float sl = kScale * attn::LOG2E;  // base-2 logits
  float* red_max = at<float>(sm, Smem::MAX);
  float* red_sum = at<float>(sm, Smem::SUM);
  float4* part = at<float4>(sm, Smem::PART);
  float2 l3b[2];  // the epilogue's l3_b
#pragma unroll
  for (int j = 0; j < 2; ++j)
    l3b[j] = ld2(a.p + a.offs[lbf_layer::L3_B] + 16 * wg + 8 * j + 2 * t);
  float s[NS];
  issue_qk(s, sm + Smem::Q, sm + Smem::KV + kw0 * Smem::ROW);
  int stage = 0;
  bool first = true;  // the stage's first tile
  // the last tile, when it was head 1's: its epilogue runs in this one
  bool epi = false;
  int eqt = 0, enq = 0;
  size_t erow0 = 0;
  for (int it = 0; cur.qt < cur.qt1; ++it) {
    const int qt = cur.qt, h = cur.h, nq = min(TM, a.Nv - qt * TM);
    const size_t row0 = (size_t)cur.b * a.Nv + qt * TM;
    const Pos nxt = next_tile(cur, kend, a.nqt);
    const bool more = nxt.qt < nxt.qt1;
    const bool next_first = more && (nxt.h != h || nxt.b != cur.b);

    // each row's max over this warpgroup's keys
    float mx[2];
    {
      wg_wait<0>();
      fence_regs(s);
      if (ragged) {
        // key 8j + 2t + (e & 1) of the warpgroup is past Nv; the column
        // groups are walked from the last down to the first that reaches
        // past it
        const int keys = a.Nv - kw0, lim = keys - 2 * t;
#pragma unroll
        for (int j = NS / 4 - 1; j >= 0; --j) {
          if (8 * j + 8 <= keys) break;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + (e & 1) >= lim) s[4 * j + e] = -CUDART_INF_F;
        }
      }
      float q[2][2];  // [row][partial]
#pragma unroll
      for (int i = 0; i < 8; ++i) q[(i >> 1) & 1][i >> 2] = s[i];
#pragma unroll
      for (int i = 8; i < NS; ++i)
        q[(i >> 1) & 1][(i >> 2) & 1] = fmaxf(q[(i >> 1) & 1][(i >> 2) & 1],
                                              s[i]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = attn::quad_max(fmaxf(q[e][0], q[e][1]));
        if (t == 0) red_max[wg * TM + ra + 8 * e] = mx[e];
      }
    }
    // warpgroup 0: the last tile's y3 and the next query tile are in
    if (wg == 0) {
      tc::cp_async_wait<0>();
      fence_async_smem();
    }
    __syncthreads();
    // copies for later tiles: warpgroup 0 the query tile after next (its
    // buffer's last reader, this tile's S, is done); warpgroups 1-3, at a
    // stage's first tile, the next stage's K and V (the slot stage - 1
    // read, done before its last tile's third barrier)
    if (wg == 0) {
      if (more) {
        const Pos nxt2 = next_tile(nxt, kend, a.nqt);
        if (nxt2.qt < nxt2.qt1)
          load_q(a, sm + Smem::Q + (it & 1) * Smem::QT, nxt2, lt);
      }
      tc::cp_async_commit();
    } else if (first) {
      const Pos ns = next_stage(cur, kend, a.nqt);
      if (ns.qt < ns.qt1) {
        load_kv(a, sm + Smem::KV + ((stage + 1) & 1) * Smem::SLOT, ns,
                threadIdx.x - WG_THREADS, THREADS - WG_THREADS);
        tc::cp_async_commit();
      }
    }
    // the last tile's epilogue, after head 1's tiles
    if (epi) {
      Epilogue ep;
      ep.product(sm, eqt, wg, lt);
      ep.store(a, sm, erow0, enq, wg, lt, l3b);
    }
    // one exponential a score against the row's max (base 2, scaled: the
    // max of the scaled scores is the scaled max), and the row's sum
    {
      float m[2], acc[2][4] = {};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* r = red_max + ra + 8 * e;
        m[e] = fmaxf(fmaxf(r[0], r[TM]), fmaxf(r[2 * TM], r[3 * TM])) * sl;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = exp2f(fmaf(s[i], sl, -m[(i >> 1) & 1]));
        acc[(i >> 1) & 1][(i >> 2) & 3] += s[i];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = attn::quad_sum((acc[e][0] + acc[e][1]) +
                                       (acc[e][2] + acc[e][3]));
        if (t == 0) red_sum[wg * TM + ra + 8 * e] = l;
      }
    }
    // at a stage's end, the next stage's K and V are in (warpgroups 1-3;
    // warpgroup 0 waited for the next query tile before the first barrier)
    if (wg > 0 && next_first) {
      tc::cp_async_wait<0>();
      fence_async_smem();
    }
    __syncthreads();
    // warpgroup 0: this tile's y3, for its epilogue in the next tile (the
    // last epilogue's reads are done)
    if (wg == 0) {
      if (h == 1) load_y3(a, sm + Smem::Y3, row0, nq, lt);
      tc::cp_async_commit();
    }
    // o = bf16(e / sum) V over this warpgroup's keys
    float o[NO];
    {
      float inv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* r = red_sum + ra + 8 * e;
        inv[e] = 1.0f / (((r[0] + r[TM]) + r[2 * TM]) + r[3 * TM]);
      }
      uint32_t pf[NS / 8][4];
#pragma unroll
      for (int ks = 0; ks < NS / 8; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[ks][r] = tc::pack_bf16(s[8 * ks + 2 * r] * inv[r & 1],
                                    s[8 * ks + 2 * r + 1] * inv[r & 1]);
      const uint64_t dv = desc64(sm + Smem::KV + (stage & 1) * Smem::SLOT +
                                 Smem::HEAD + kw0 * Smem::ROW);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < NS / 8; ++ks) mma_pv(o, pf[ks], dv + 64 * ks, ks);
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
    }
#pragma unroll
    for (int i = 0; i < NO / 4; ++i)
      part[(wg * 4 + i) * WG_THREADS + lt] =
          make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
    if (more)
      issue_qk(s, sm + Smem::Q + ((it + 1) & 1) * Smem::QT,
               sm + Smem::KV + ((stage + next_first) & 1) * Smem::SLOT +
                   kw0 * Smem::ROW);
    __syncthreads();
    // the four partial tiles summed, a quarter each (o's entries 4 wg ..
    // 4 wg + 3: columns 8 wg + 2t, + 1 of rows ra, ra + 8), rounded to
    // bf16: head 0's into the sample's rows, head 1's into O1
    {
      float4 v = part[wg * WG_THREADS + lt];
#pragma unroll
      for (int w = 1; w < WGS; ++w) {
        const float4 u = part[(w * 4 + wg) * WG_THREADS + lt];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      unsigned char* od = h == 0 ? sm + Smem::O0 + qt * Smem::QT
                                 : sm + Smem::O1;
      *reinterpret_cast<uint32_t*>(od + swz64(ra, wg) + 4 * t) =
          tc::pack_bf16(v.x, v.y);
      *reinterpret_cast<uint32_t*>(od + swz64(ra + 8, wg) + 4 * t) =
          tc::pack_bf16(v.z, v.w);
    }
    epi = h == 1;
    eqt = qt;
    enq = nq;
    erow0 = row0;
    first = next_first;
    stage += first;
    cur = nxt;
  }
  // no S is in flight past the last tile (it issues none); the wait says so
  wg_wait<0>();
  if (epi) {
    if (wg == 0) {
      tc::cp_async_wait<0>();
      fence_async_smem();
    }
    __syncthreads();
    Epilogue ep;
    ep.product(sm, eqt, wg, lt);
    ep.store(a, sm, erow0, enq, wg, lt, l3b);
  }
}

// q2, k2, v2 bf16 and y3, xout f32 [B, Nv, 64], Nv <= NV_WG
inline int launch(const void* q2, const void* k2, const void* v2,
                  const void* y3, const void* weights, const void* offs,
                  void* xout, int B, int Nv, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lbf_selfattn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem::BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const Args a{static_cast<const __nv_bfloat16*>(q2),
               static_cast<const __nv_bfloat16*>(k2),
               static_cast<const __nv_bfloat16*>(v2),
               static_cast<const float*>(y3),
               static_cast<const __nv_bfloat16*>(weights),
               static_cast<const int*>(offs), static_cast<float*>(xout), B,
               Nv, (Nv + TM - 1) / TM};
  const int total = B * a.nqt;
  if (total == 0) return 0;
  lbf_selfattn_kernel<<<(int)(total < sms ? total : sms), THREADS,
                        Smem::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch's plan: sa[1] CTAs resident an SM, [2] keys a staged K/V row
// (NV_WG), [3] shared-memory bytes, [4] registers a thread, [5] warpgroups
// a CTA. Returns a cudaError_t.
inline int plan(int* sa) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      lbf_selfattn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem::BYTES);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, lbf_selfattn_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &sa[1], lbf_selfattn_kernel, THREADS, Smem::BYTES);
  sa[2] = NV_WG;
  sa[3] = Smem::BYTES;
  sa[4] = err == cudaSuccess ? attr.numRegs : 0;
  sa[5] = WGS;
  return (int)err;
}

}  // namespace lbf_sa_wg
}  // namespace gator
