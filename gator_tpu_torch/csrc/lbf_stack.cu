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
//   rows:         per (row tile, sample): the cross-attention over the
//                 whole J-key joint set, LN2, the MLP, the std-LN and the
//                 q2/k2/v2 projections. Writes y3 (f32) and q2/k2/v2 (T),
//                 under T1's rounding policy, which is K2's: products and
//                 bias adds in f32, operands rounded to T where they enter
//                 a product. Two kernels, split on the dtype:
//                 bf16, lbf_rows_wg.cuh's `rows_kernel`: one persistent
//                 CTA an SM with the layer's weights resident in shared
//                 memory, warpgroups on 64-row tiles, every product a
//                 `wgmma` with A from registers. f32 (3xTF32),
//                 lbf_layer.cuh's `rows_kernel` (shared with K2-layer and
//                 T1): 16-row tiles, the weights through a two-slot
//                 cp.async ring, `mma.sync`. Each file holds its design and
//                 bounds.
//   lbf_selfattn: per (64-query tile, sample), both heads, one CTA of
//                 eight warps (four per head, 16 query rows each): the
//                 two-pass attention of attn_tc.cuh (shared with K3) on
//                 the tensor cores, the sample's K and V staged whole-row
//                 (both heads, 64 wide) with cp.async in chunks that let
//                 two CTAs share an SM (bf16 at Nv = 431: 384 + 47 keys;
//                 f32: 192-key chunks); the normalised probabilities
//                 rounded to T, as the TPU kernel rounds them
//                 (pallas_mdr.py:342), then PV in f32 rounded to T. The
//                 epilogue puts the tile's T(o) [64, 64] in shared memory
//                 beside L3's weights (cp.async) and adds o @ L3 + l3_b to
//                 y3 on the tensor cores into x' (f32).
// The residual stream between layers stays f32. The ragged 431 edge is
// masked by row counts; the TPU kernel's 431->432 and J->24 row padding
// and its block-diagonal cross mask are gone. Past the grid's 65535
// samples the self-attention launches again; the rows launch has a 1-D
// persistent grid.
//
// What bounds it on the H100 (B = 2048, Nv = 431, J = 17, a layer, bf16):
// rows 49 GFMA (0.10 ms at 989 TFLOP/s) against 0.79 GB (0.24 ms);
// self-attention 52 GFMA (0.11 ms; 76 with pass 1's scores) against
// 0.79 GB of q2/k2/v2 and y3 in and x' out (0.24 ms), and 760 M
// exponentials twice. Both are bound by the bytes; measured on one H100
// 80GB HBM3 at 700 W the self-attention takes 1.41 ms a layer
// (tools/profile_lbf.py; the rows launch's time is in
// lbf_rows_wg.cuh). bf16 products are exact, so only the f32 sums reorder;
// f32 runs as 3xTF32 (mma.cuh), never single TF32.
#include "attn_tc.cuh"
#include "lbf_layer.cuh"
#include "lbf_rows_wg.cuh"

namespace gator {
namespace lbf {

using namespace lbf_layer;

constexpr int SA_WARPS = 8;  // four per head, 16 query rows each
constexpr int SA_ROWS = 64;  // query rows per CTA

// the staged K/V rows (both heads), and the epilogue's O tile and L3
// weights, which reuse them
template <typename T>
struct SelfAttn {
  using Pad = attn::Pad<T, C>;
  static constexpr int LO = Pad::LK, LW = Pad::LV;
  static int smem(int kc) { return kc * Pad::KEY_BYTES; }
  static_assert(SA_ROWS * (LO + LW) <= attn::KT * (Pad::LK + Pad::LV),
                "the epilogue fits in one key tile's staging");
};

// two CTAs per SM: at most 128 registers a thread
template <typename T>
__global__ void __launch_bounds__(32 * SA_WARPS, 2)
    lbf_selfattn_kernel(const T* __restrict__ q2, const T* __restrict__ k2,
                        const T* __restrict__ v2, const float* __restrict__ y3,
                        const T* __restrict__ p, const int* __restrict__ offs,
                        float* __restrict__ xout, int b0, int Nv, int kc) {
  using P = tc::Mma<T>;
  using S = SelfAttn<T>;
  constexpr int KSTEPS = attn::ksteps<T, D>();
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kc * S::Pad::LK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = warp / 4;
  const int r0 = blockIdx.x * SA_ROWS;
  const int wr = (warp % 4) * 16;  // the warp's first row in the tile
  const int m0 = r0 + wr;
  const bool active = m0 < Nv;
  const size_t base = (size_t)(b0 + blockIdx.y) * Nv;

  typename P::A qf[KSTEPS];
  {
    const T* qb = q2 + (base + m0) * C + h * D;
    const int nr = Nv - m0;
    auto qa = [&](int m, int d) {
      return m < nr ? ld(qb + m * C + d) : 0.0f;
    };
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) qf[ks] = P::load_a(qa, 0, ks * P::KS);
  }
  // base-2 logits, s * scale * log2(e); -inf past the last key
  constexpr float sl = kScale * attn::LOG2E;
  auto finish = [&](float (&s)[8][4], int key0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] *= sl;
    if (key0 + attn::KT > Nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (key0 + 8 * j + 2 * t + (i & 1) >= Nv) s[j][i] = -CUDART_INF_F;
    }
  };
  float o[NO][4];
  attn::two_pass<T, D, C>(
      o, qf, Ks + h * D, Vs + h * D, Nv, kc, active,
      [&](int key0, int n, bool with_v) {
        attn::stage_kv<T, C>(Ks, Vs, k2 + base * C, v2 + base * C, C, C,
                             key0, n, with_v);
      },
      finish);

  // x' = y3 + (T(o) @ L3 + b): T(o) and L3 into the staging space
  __syncthreads();  // K and V are read no more
  T* O = Ks;
  T* W3 = O + SA_ROWS * S::LO;
  tc::stage(W3, S::LW, p + offs[L3_W], C, C, C);
  tc::cp_async_commit();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    T* orow = O + (wr + g + 8 * rr) * S::LO + h * D + 2 * t;
#pragma unroll
    for (int jn = 0; jn < NO; ++jn) {
      orow[8 * jn] = Num<T>::from_float(o[jn][2 * rr]);
      orow[8 * jn + 1] = Num<T>::from_float(o[jn][2 * rr + 1]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  const int nq = min(SA_ROWS, Nv - r0);
  const T* l3_b = p + offs[L3_B];
  tc::gemm<T, 2>(SA_ROWS / 16, C / 8, C, tc::RowMajor<T>{O, S::LO},
                 tc::RowMajor<T>{W3, S::LW},
                 [&](int m, int c, float v, float w) {
                   if (m < nq) {
                     const size_t i = (base + r0 + m) * C + c;
                     const float2 y = ld2(y3 + i), b = ld2(l3_b + c);
                     st2(xout + i, y.x + v + b.x, y.y + w + b.y);
                   }
                 });
}

template <typename T>
int launch_selfattn(const void* q2, const void* k2, const void* v2,
                    const void* y3, const void* weights, const void* offs,
                    void* xout, int B, int Nv, cudaStream_t stream) {
  auto kern = lbf_selfattn_kernel<T>;
  const int kc = attn::chunk_keys<T, C>(Nv);
  const int smem = SelfAttn<T>::smem(kc);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_B) {
    dim3 grid((Nv + SA_ROWS - 1) / SA_ROWS,
              B - b0 < MAX_GRID_B ? B - b0 : MAX_GRID_B);
    kern<<<grid, 32 * SA_WARPS, smem, stream>>>(
        static_cast<const T*>(q2), static_cast<const T*>(k2),
        static_cast<const T*>(v2), static_cast<const float*>(y3),
        static_cast<const T*>(weights), static_cast<const int*>(offs),
        static_cast<float*>(xout), b0, Nv, kc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The self-attention launch's plan at Nv keys: keys per staged K/V chunk
// into *kc, CTAs resident per SM on the current device into *ctas_per_sm
template <typename T>
int selfattn_plan(int Nv, int* kc, int* ctas_per_sm) {
  auto kern = lbf_selfattn_kernel<T>;
  *kc = attn::chunk_keys<T, C>(Nv);
  const int smem = SelfAttn<T>::smem(*kc);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kern, 32 * SA_WARPS, smem);
  return (int)err;
}

}  // namespace lbf
}  // namespace gator

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its
// launch. x, y3 and xout are f32 [B, Nv, 64]; joints, q2, k2, v2 are T.
// The rows launch takes lbf_rows_wg.cuh's kernel in bf16 and lbf_layer.cuh's
// in f32, and counts each launch under the kernel it took;
// lbf_rows_shared_launch runs lbf_layer.cuh's in either dtype, uncounted
// (the card tests hold the two against each other).
extern "C" int lbf_rows_shared_launch(int dtype, const void* x,
                                      const void* joints,
                                      const void* weights, const void* offs,
                                      void* y3, void* q2, void* k2, void* v2,
                                      int B, int Nv, int J, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using gator::lbf_layer::FULL;
  using gator::lbf_layer::launch_rows;
  if (dtype == 0)
    return launch_rows<float, false, FULL, float>(
        x, joints, weights, offs, y3, q2, k2, v2, nullptr, B, Nv, J, s);
  return launch_rows<__nv_bfloat16, false, FULL, float>(
      x, joints, weights, offs, y3, q2, k2, v2, nullptr, B, Nv, J, s);
}

namespace {

// the rows kernels, as lbf_rows_launch and lbf_stack_plan index them
enum RowsKernel { ROWS_SHARED = 0, ROWS_WG = 1 };

RowsKernel rows_kernel_of(int dtype) {
  return dtype == 0 ? ROWS_SHARED : ROWS_WG;
}

// lbf_rows_launch's launches in this process, by RowsKernel
long long rows_launched[2];

}  // namespace

extern "C" int lbf_rows_launch(int dtype, const void* x, const void* joints,
                               const void* weights, const void* offs,
                               void* y3, void* q2, void* k2, void* v2, int B,
                               int Nv, int J, void* stream) {
  const RowsKernel kern = rows_kernel_of(dtype);
  const int err =
      kern == ROWS_SHARED
          ? lbf_rows_shared_launch(dtype, x, joints, weights, offs, y3, q2,
                                   k2, v2, B, Nv, J, stream)
          : gator::lbf_wg::launch_rows(x, joints, weights, offs, y3, q2, k2,
                                       v2, B, Nv, J,
                                       static_cast<cudaStream_t>(stream));
  if (err == 0) ++rows_launched[kern];
  return err;
}

// lbf_rows_launch's launches so far, by RowsKernel: out[0] lbf_layer.cuh's,
// out[1] lbf_rows_wg.cuh's. Returns 0.
extern "C" int lbf_rows_launch_counts(long long* out) {
  out[ROWS_SHARED] = rows_launched[ROWS_SHARED];
  out[ROWS_WG] = rows_launched[ROWS_WG];
  return 0;
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

namespace {

// lbf_layer.cuh's rows_kernel for T, under K2's policy: rows[0] CTAs an
// SM, [1] rows a tile, [2] shared bytes, [3] registers
template <typename T>
int shared_rows_plan(int* rows) {
  using namespace gator::lbf_layer;
  auto kern = rows_kernel<T, false, FULL, float>;
  const int smem = RowsSmem<T>::BYTES;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &rows[0], kern, NT_ROWS, smem);
  if (err == 0) err = (int)cudaFuncGetAttributes(&attr, kern);
  rows[1] = RowsSmem<T>::TR;
  rows[2] = smem;
  rows[3] = err == 0 ? attr.numRegs : 0;
  rows[4] = 0;
  return err;
}

}  // namespace

// The self-attention launch's plan (keys per K/V chunk, CTAs per SM) at Nv
// keys, and the plan of the rows kernel that lbf_rows_launch takes in that
// dtype: rows[0] CTAs an SM, [1] rows a tile, [2] shared bytes, [3]
// registers a thread, [4] warpgroups a CTA (0: lbf_layer.cuh's kernel,
// which has none of its own), [5] the kernel (RowsKernel). Returns a
// cudaError_t.
extern "C" int lbf_stack_plan(int dtype, int Nv, int* kc, int* sa_ctas,
                              int* rows) {
  rows[5] = rows_kernel_of(dtype);
  if (dtype == 0) {
    const int err = gator::lbf::selfattn_plan<float>(Nv, kc, sa_ctas);
    return err != 0 ? err : shared_rows_plan<float>(rows);
  }
  const int err = gator::lbf::selfattn_plan<__nv_bfloat16>(Nv, kc, sa_ctas);
  return err != 0 ? err : gator::lbf_wg::plan(rows);
}
