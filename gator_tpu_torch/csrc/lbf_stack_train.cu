// K4: one MDR LBF layer in training mode, forward and backward kernels.
//
// Replaces gator_tpu/nn/pallas_mdr_train.py:592 `lbf_stack_train` (custom
// VJP `lbf_layer_train:568`; forward `_fwd_kernel:404`, backward
// `_bwd_kernel:420`). Per layer and sample (reference: lib/models/MDR.py):
//   x1  = x + DropPath1(ProjDrop(Proj(AttnDrop(CrossAttn(LN1 x -> LN1 j)))))
//   x2  = x1 + DropPath2(MlpDrop(fc2(MlpDrop(gelu(fc1(LN2 x1))))))
//   y3  = StdLN(x2)
//   out = y3 + OutDrop(L3(SelfDrop(SelfAttn(L0 y3, L1 y3, L2 y3))))
// with dropout at six sites drawn in-kernel from the hash of
// csrc/dropout.cuh, keyed per (seed, layer, sample, mask-id, element).
//
// Design. The TPU kernel holds a sample's two [431, 431] probability
// matrices in VMEM in both passes; on the H100 one of them is 743 KB in
// f32, more than a CTA's 227 KB. So the layer is cut into launches where
// rows stop being independent, as K2 (csrc/lbf_stack.cu), and the
// self-attention is flash-style:
//   forward   lbf_rows_fwd   per TR-row tile: cross-attention, MLP,
//                            std-LN, q2/k2/v2 (saved in T);
//             lbf_sa_fwd     per 64-query tile, both heads: attn_tc.cuh's
//                            two passes over 64-key tiles, the normalised
//                            probabilities times the self mask rounded to
//                            T before PV (pallas_mdr_train.py:257); saves
//                            the output a2 (f32) and each row's base-2
//                            log-sum-exp, then L3, the out mask and y3;
//   backward  lbf_sa_bwd_dq  per 64-query tile: dsa = g * m_out, L3's
//                            bias share and the operands of its weight
//                            gradient (to `ops`), da2 = dsa L3^T (saved in
//                            T), D = <da2, a2> per head; then over 64-key
//                            tiles P = exp2(s - lse), the mask from the
//                            hash, dS = T(P (M dP - D) scale), dq2 += dS K;
//             lbf_sa_bwd_dkv per 64-key tile, over 32-query steps: the
//                            same transposed, dv2 += T(P M)^T dA, dk2 +=
//                            dS^T Q;
//             lbf_rows_bwd   per TR-row tile: recomputes the row-local
//                            forward, backpropagates to dx, leaves its
//                            tile's share of the joints' dk/dv, the bias
//                            and norm gradients, and, per row, the two
//                            operands of every weight gradient (`ops`);
//             lbf_joints_bwd per sample: sums those shares (and L3's bias
//                            shares) in order; wk/wv gradients and the LN1
//                            backward of the joint rows -> djoints;
//             lbf_wgrad      the weight gradients, X^T dY over all B * Nv
//                            rows of `ops` in fixed chunks (L3's too);
//             lbf_reduce     sums each gradient field over the partial rows
//                            that wrote it.
// No launch holds a probability matrix; dS = P * (M * dP - D) per tile.
// Each launch writes only the gradient fields it owns, into compact
// partial rows (per lbf_wgrad chunk, lbf_rows_bwd CTA, lbf_joints_bwd CTA)
// of fixed grids, summed in a fixed order; no atomics, so repeat runs are
// bit-identical.
//
// Every product runs on the tensor cores (csrc/mma.cuh): bf16 m16n8k16 on
// the operands the kernel rounds to bf16 anyway, or in f32 the 3xTF32
// split. The row-local launches keep a tile's activations in shared
// memory, in T where they only ever meet a product rounded (layer-norm
// outputs, q, a1, h1, the probabilities times the masks, da1, dq) and in
// f32 where the layer keeps f32 (residuals, scores, backward cotangents);
// each product's weights are staged into shared memory with cp.async, one
// [64, 64] block at a time. At TR = 16 rows a CTA takes 72.6 KB in bf16,
// so three fit on an SM (TR = 32 and two-per-SM versions measured slower
// on the H100). A CTA walks a contiguous run of tiles, so the joints' LN1,
// K and V are computed once per sample it meets, not once per tile. The
// weight gradients are not accumulated per tile: lbf_rows_bwd writes each
// row's operands (`ops`, 2.5 KB a row in bf16) and lbf_wgrad sums them.
// The self-attention launches keep each warp's 16 rows of q (or k and v,
// or dA) as mma fragments in registers, stage the sample's other operand
// rows (both heads, 64 wide) with cp.async in their own dtype in chunks
// that let two CTAs share an SM, and turn score accumulators into the next
// product's A operand in registers (attn_tc.cuh's `scores` and `pv`).
//
// Interfaces between the launches, by type: q2/k2/v2 and da2 are saved in
// T (every reader rounds them to T: the JAX backward's mmT/mmf/mTm round
// their operands), so cp.async stages them as they are; y3, a2, the
// log-sum-exp, D and dq2/dk2/dv2 stay f32 (the residual, D's sum and the
// bias gradients take them unrounded).
//
// What bounds it on the H100: a stage-2 step's row launches need ~37 GFMA
// forward and ~100 backward (0.07 and 0.2 ms on bf16 tensor cores) and
// move ~0.76 GB each way (0.23 ms); they take about 10x and 30x that,
// in the element-wise work between the products (dropout hashes,
// exponentials, GELU, LayerNorms), the block's syncs and the staging. The
// self-attention launches need ~2 Nv^2 C FMA forward and ~7 Nv^2 C
// backward per sample and layer (~0.35 ms in all on bf16 tensor cores at
// B = 512, Nv = 431, 3 layers) and move ~2.3 GB through their interfaces
// (~0.7 ms): bytes bound. On one H100 80GB HBM3 at 700 W they take about
// 1.5 (forward), 1.4 (dq) and 1.2 ms (dk/dv) per stage-2 step, ~6x their
// bounds, with one dropout hash and one or two exponentials per score;
// the joints' launch ~0.3 ms, reading each row tile's share, and the
// reduction ~0.04 ms (chip_smoke.py phase 14 prints each launch beside
// its bound; tools/profile_train.py).
#include "attn_tc.cuh"
#include "train_ops.cuh"

namespace gator {
namespace ltrain {

constexpr int C = 64;     // token width
constexpr int H = 2;      // heads
constexpr int D = 32;     // head width
constexpr int HID = 256;  // MLP hidden
constexpr int JMAX = 32;  // most joint tokens
constexpr int TR = 16;    // vertex rows per rows-kernel tile
constexpr int NT = 256;   // threads of every launch but the reduction's
constexpr int TQ = 64;    // query (or key) rows per self-attention CTA
constexpr float SCALE = 0.17677669529663687f;  // D^-0.5
// The self-attention works in base 2: logits s * SL, and the forward saves
// each row's log-sum-exp in that base, lse2 = max + log2(sum of
// exp2(logit - max)), so that the backward's probabilities are
// P = exp2(s * SL - lse2).
constexpr float SL = SCALE * attn::LOG2E;
constexpr int QSTEP = 4;  // 8-column tiles per step of the backward's loops

// Field order of a layer's packed weights (and of its gradients); must
// match LAYER_PARAM_KEYS in gator_tpu_torch/nn/lbf_stack_train.py.
enum Field {
  N1_W, N1_B, WQ, WK, WV, PROJ_W, PROJ_B, N2_W, N2_B,
  FC1_W, FC1_B, FC2_W, FC2_B, A2W, B2W,
  L0_W, L0_B, L1_W, L1_B, L2_W, L2_B, L3_W, L3_B, NFIELD
};

// Columns of one row of `ops` (T [B * Nv, O_W]): the forward activations
// and backward cotangents that meet in a weight gradient (O_A2 and O_DSA,
// L3's, are written by lbf_sa_bwd_dq, the rest by lbf_rows_bwd).
enum OpCol {
  O_YV = 0, O_A1 = 64, O_Y2 = 128, O_Y3 = 192, O_H1D = 256,
  O_DQ2 = 512, O_DK2 = 576, O_DV2 = 640, O_DQ = 704, O_DO = 768,
  O_DH2 = 832, O_DH1 = 896, O_A2 = 1152, O_DSA = 1216, O_W = 1280
};

// The compact gradient partials (f32). A row of each kind holds only the
// fields its launch owns, at these offsets (-1: not there):
//   woff   per lbf_wgrad chunk, the eight weights it forms (NW floats);
//   roff   per lbf_rows_bwd CTA, the row-local biases and norms (NR);
//   jpoff  per lbf_joints_bwd CTA, wk, wv, norm1 and L3's bias (NJP).
__host__ __device__ constexpr int woff(int f) {
  return f == WQ ? 0 : f == PROJ_W ? C * C : f == FC1_W ? 2 * C * C
       : f == FC2_W ? 6 * C * C : f == L0_W ? 10 * C * C
       : f == L1_W ? 11 * C * C : f == L2_W ? 12 * C * C
       : f == L3_W ? 13 * C * C : -1;
}
constexpr int NW = 14 * C * C;

__host__ __device__ constexpr int roff(int f) {
  return f == N1_W ? 0 : f == N1_B ? C : f == PROJ_B ? 2 * C
       : f == N2_W ? 3 * C : f == N2_B ? 4 * C : f == FC1_B ? 5 * C
       : f == FC2_B ? 5 * C + HID : f == A2W ? 6 * C + HID
       : f == B2W ? 7 * C + HID : f == L0_B ? 8 * C + HID
       : f == L1_B ? 9 * C + HID : f == L2_B ? 10 * C + HID : -1;
}
constexpr int NR = 11 * C + HID;

__host__ __device__ constexpr int jpoff(int f) {
  return f == WK ? 0 : f == WV ? C * C : f == N1_W ? 2 * C * C
       : f == N1_B ? 2 * C * C + C : f == L3_B ? 2 * C * C + 2 * C : -1;
}
constexpr int NJP = 2 * C * C + 3 * C;

template <typename T>
struct Args {
  const T* x;        // [B, Nv, C] layer input
  const T* jt;       // [B, J, C] joint tokens
  const T* w;        // packed weights
  const int* offs;   // field offsets
  const T* gout;     // [B, Nv, C] output cotangent
  T* out;            // [B, Nv, C] layer output
  T* dx;             // [B, Nv, C]
  T* djt;            // [B, J, C]
  T* ops;            // [B * Nv, O_W] weight-gradient operands (backward)
  float* y3;         // [B, Nv, C] (forward)
  T* q2;             // [B, Nv, C] saved by the forward
  T* k2;
  T* v2;
  float* a2;         // [B, Nv, C] self-attention output after dropout
  float* lse;        // [B, H, Nv] its base-2 log-sum-exp
  T* da2;            // [B, Nv, C]
  float* dd;         // [B, H, Nv] D_i
  float* dq2;        // [B, Nv, C]
  float* dk2;
  float* dv2;
  float* djk;        // [B, nrt, J, C] per-tile shares of the joints' dk
  float* djv;        // and dv
  float* l3b;        // [B, nqt, C] per-query-tile shares of L3's bias grad
  float* pw;         // [nc_w, NW] lbf_wgrad's partial rows
  float* pr;         // [nc_rows, NR] lbf_rows_bwd's
  float* pj;         // [nc_j, NJP] lbf_joints_bwd's
  float* masks;      // mask export (forward; may be null)
  int B, Nv, J;
  int nrt;           // row tiles of the rows kernels per sample
  int nqt;           // 64-row tiles of the self-attention per sample
  uint32_t seed;
  int unit;
  int sample0;       // global index of sample 0 (keys the dropout masks)
  Drop attn, proj, path, mlp, self_, outd;
};

// the stream key of local sample b's mask `mid` (keyed by its global index)
template <typename T>
__device__ __forceinline__ uint32_t skey(const Args<T>& a, int b, int mid) {
  return stream_key(a.seed, a.unit, a.sample0 + b, mid);
}

template <typename T>
struct Export {
  size_t attn, proj, dp1, mlp1, mlp2, dp2, self_, out;
  __device__ Export(const Args<T>& a) {
    const size_t B = a.B, Nv = a.Nv, J = a.J;
    attn = 0;
    proj = attn + B * H * Nv * J;
    dp1 = proj + B * Nv * C;
    mlp1 = dp1 + B;
    mlp2 = mlp1 + B * Nv * HID;
    dp2 = mlp2 + B * Nv * C;
    self_ = dp2 + B;
    out = self_ + B * H * Nv * Nv;
  }
};

using tc::ColMajor;
using tc::RowMajor;

// Shared memory of the rows kernels, in bytes from the start. Rows of
// width w are padded by 16 bytes (w + 4 f32, w + 16 / sizeof(T) T), so
// that the fragment loads of a warp fall in distinct banks. U is used
// twice: by the forward's transient buffers and, once they are dead, by
// the backward's.
template <typename T>
struct Rows {
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int LF = C + 4, LFH = HID + 4;      // f32 row strides
  static constexpr int LT = C + E, LTH = HID + E, LT3 = 3 * C + E;  // T
  static constexpr int FB = TR * LF * 4;               // [TR, C] f32
  static constexpr int TB = TR * LT * (int)sizeof(T);  // [TR, C] T
  static constexpr int JB = JMAX * LT * (int)sizeof(T);
  // live through the tile
  static constexpr int X = 0, P = X + FB, X1 = P + FB, X2 = X1 + FB,
                       Q = X2 + FB, PM = Q + TB, Y2 = PM + TB, KJ = Y2 + TB,
                       VJ = KJ + JB, STATS = VJ + JB, U = STATS + TR * 8;
  // U in the forward: the joints' input and LN1 (while a sample's K and V
  // are made), then the rounded operands
  static constexpr int JT = U, YJ = JT + JMAX * LF * 4;
  static constexpr int YV = U, A1 = YV + TB, Y3 = A1 + TB, H1D = Y3 + TB;
  static constexpr int U_FWD =
      cmax(YJ + JB, H1D + TR * LTH * (int)sizeof(T)) - U;
  // U in the backward: three [TR, C] f32 slots and one [TR, HID] f32 (the
  // recomputed pre-activation, then dh1; before it the stacked dq2/dk2/dv2
  // in T, after it da1 and dq in T)
  static constexpr int S0 = U, S1 = S0 + FB, S2 = S1 + FB, R = S2 + FB;
  static constexpr int U_BWD = R + TR * LFH * 4 - U;
  static constexpr int WS = U + cmax(U_FWD, U_BWD);
  static constexpr int BYTES = WS + C * LT * (int)sizeof(T);  // + [64, 64]
  // CTAs an SM should hold: three in bf16 (72.6 KB each, so at most 85
  // registers a thread); in f32 (93 KB) what the registers allow
  static constexpr int MIN_CTAS = sizeof(T) == 2 ? 3 : 1;
  static_assert(TR % 16 == 0, "whole mma row tiles");
  static_assert(TR * LT3 * (int)sizeof(T) <= TR * LFH * 4,
                "dq2/dk2/dv2 fit in R");
  static_assert(2 * TB <= TR * LFH * 4, "da1 and dq fit in R");
};

// stage the [64, 64] block at (r0, c0) of a weight whose rows are ldw
// apart into WS (rows 64 + 16 / sizeof(T) apart) and commit; `ready`
// waits for every staged copy and syncs the block. The [64, 256] and
// [256, 64] MLP weights go through in four blocks, so that a CTA needs
// 72.6 KB of shared memory in bf16 and three fit on an SM.
template <typename T>
__device__ __forceinline__ void load_w(T* WS, const T* W, int ldw, int r0,
                                       int c0) {
  tc::stage(WS, C + 16 / (int)sizeof(T), W + r0 * ldw + c0, ldw, C, C);
  tc::cp_async_commit();
}

__device__ __forceinline__ void ready() {
  tc::cp_async_wait<0>();
  __syncthreads();
}

// The row-local forward of one (sample, tile) of TR rows, on the tensor
// cores; leaves in shared memory what the backward reads. Rows past the
// last vertex are computed from zero inputs (finite, and zero in every
// cotangent) and never written out. fwd: write y3/q2/k2/v2 and export
// masks; else write the weight-gradient operands of the forward to `ops`.
// `jb` is the sample whose joints' K and V are in shared memory.
template <typename T>
__device__ void rows_fwd(const Args<T>& a, unsigned char* sm, int b, int tile,
                         bool fwd, int& jb) {
  using L = Rows<T>;
  using N = Num<T>;
  constexpr int MT = TR / 16, NB = TR / 16;
  const int Nv = a.Nv, J = a.J;
  const int r0 = tile * TR;
  const int nr = min(TR, Nv - r0);
  const size_t row0 = (size_t)b * Nv + r0;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  float* X = at<float>(sm, L::X);
  float* P = at<float>(sm, L::P);
  float* X1 = at<float>(sm, L::X1);
  float* X2 = at<float>(sm, L::X2);
  T* Q = at<T>(sm, L::Q);
  T* PM = at<T>(sm, L::PM);
  T* Y2 = at<T>(sm, L::Y2);
  T* KJ = at<T>(sm, L::KJ);
  T* VJ = at<T>(sm, L::VJ);
  T* YV = at<T>(sm, L::YV);
  T* A1 = at<T>(sm, L::A1);
  T* Y3 = at<T>(sm, L::Y3);
  T* H1D = at<T>(sm, L::H1D);
  T* WS = at<T>(sm, L::WS);
  const float scale = rsqrtf((float)D);
  const bool dump = fwd && a.masks != nullptr;
  const Export<T> ex(a);
  // a weight-gradient operand of row r (backward only), rounded to T
  auto put = [&](int col, int r, int c, float v) {
    if (!fwd && r < nr) a.ops[(row0 + r) * O_W + col + c] = N::from_float(v);
  };

  __syncthreads();  // the previous tile is done with every buffer
  if (b != jb) {
    // this sample's joints: LN1 (rows J.. zero), then K and V
    jb = b;
    float* JT = at<float>(sm, L::JT);
    T* YJ = at<T>(sm, L::YJ);
    load_w(WS, p + o[WK], C, 0, 0);
    for (int i = tid; i < J * C; i += NT)
      JT[i / C * L::LF + i % C] = N::to_float(a.jt[(size_t)b * J * C + i]);
    for (int i = tid; i < (JMAX - J) * C; i += NT)
      YJ[(J + i / C) * L::LT + i % C] = N::from_float(0.0f);
    __syncthreads();
    layer_norm_rows<C>(JT, L::LF, J, p + o[N1_W], p + o[N1_B], 1e-5f, false,
                       [&](int r, int c, float v) {
                         YJ[r * L::LT + c] = N::from_float(v);
                       });
    ready();
    tc::gemm<T, 1>(JMAX / 16, C / 8, C, RowMajor<T>{YJ, L::LT},
                   RowMajor<T>{WS, L::LT}, [&](int r, int c, float v) {
                     KJ[r * L::LT + c] = N::from_float(v);
                   });
    __syncthreads();
    load_w(WS, p + o[WV], C, 0, 0);
    ready();
    tc::gemm<T, 1>(JMAX / 16, C / 8, C, RowMajor<T>{YJ, L::LT},
                   RowMajor<T>{WS, L::LT}, [&](int r, int c, float v) {
                     VJ[r * L::LT + c] = N::from_float(v);
                   });
    __syncthreads();
  }

  load_w(WS, p + o[WQ], C, 0, 0);
  for (int i = tid; i < TR * C; i += NT) {
    const int r = i / C, c = i % C;
    X[r * L::LF + c] = r < nr ? N::to_float(a.x[(row0 + r) * C + c]) : 0.0f;
  }
  __syncthreads();
  layer_norm_rows<C>(X, L::LF, TR, p + o[N1_W], p + o[N1_B], 1e-5f, false,
                     [&](int r, int c, float v) {
                       YV[r * L::LT + c] = N::from_float(v);
                       put(O_YV, r, c, v);
                     });
  ready();
  tc::gemm<T, NB>(MT, C / 8, C, RowMajor<T>{YV, L::LT},
                  RowMajor<T>{WS, L::LT}, [&](int r, int c, float v) {
                    Q[r * L::LT + c] = N::from_float(v);
                  });
  __syncthreads();
  load_w(WS, p + o[PROJ_W], C, 0, 0);

  // cross-attention over the J joint keys (padded to JMAX): scores per
  // head on the tensor cores, softmax and masks per (row, head), then the
  // masked probabilities, rounded, times v
  for (int h = 0; h < H; ++h)
    tc::gemm<T, 1>(MT, JMAX / 8, D, RowMajor<T>{Q + h * D, L::LT},
                   ColMajor<T>{KJ + h * D, L::LT}, [&](int r, int m, float v) {
                     P[r * L::LF + h * JMAX + m] = v * scale;
                   });
  __syncthreads();
  for (int task = tid; task < H * TR; task += NT) {
    const int h = task / TR;
    const int r = task % TR;
    const int n = r0 + r;
    const uint32_t key = skey(a, b, M_ATTN0 + h);
    float* prow = P + r * L::LF + h * JMAX;
    T* pmrow = PM + r * L::LT + h * JMAX;
    float mx = -CUDART_INF_F;
    for (int m = 0; m < J; ++m) mx = fmaxf(mx, prow[m]);
    float sum = 0.0f;
    for (int m = 0; m < J; ++m) {
      const float e = expf(prow[m] - mx);
      prow[m] = e;
      sum += e;
    }
    for (int m = 0; m < J; ++m) {
      const float mk = drop(key, n * J + m, a.attn);
      prow[m] /= sum;
      pmrow[m] = N::from_float(prow[m] * mk);
      if (dump && r < nr)
        a.masks[ex.attn + (((size_t)b * H + h) * Nv + n) * J + m] = mk;
    }
    for (int m = J; m < JMAX; ++m) {
      prow[m] = 0.0f;
      pmrow[m] = N::from_float(0.0f);
    }
  }
  __syncthreads();
  for (int h = 0; h < H; ++h)
    tc::gemm<T, 1>(MT, D / 8, JMAX, RowMajor<T>{PM + h * JMAX, L::LT},
                   RowMajor<T>{VJ + h * D, L::LT}, [&](int r, int c, float v) {
                     A1[r * L::LT + h * D + c] = N::from_float(v);
                     put(O_A1, r, h * D + c, v);
                   });
  ready();

  // x1 = x + DropPath1(ProjDrop(a1 @ proj + b))
  const T* proj_b = p + o[PROJ_B];
  const float dp1 = drop(skey(a, b, M_DP1), 0, a.path);
  if (dump && tile == 0 && tid == 0) a.masks[ex.dp1 + b] = dp1;
  const uint32_t kproj = skey(a, b, M_PROJ);
  tc::gemm<T, NB>(MT, C / 8, C, RowMajor<T>{A1, L::LT},
                  RowMajor<T>{WS, L::LT}, [&](int r, int c, float v) {
                    const int n = r0 + r;
                    const float mk = drop(kproj, n * C + c, a.proj);
                    if (dump && r < nr)
                      a.masks[ex.proj + ((size_t)b * Nv + n) * C + c] = mk;
                    X1[r * L::LF + c] =
                        X[r * L::LF + c] + (v + ld(proj_b + c)) * mk * dp1;
                  });
  __syncthreads();
  load_w(WS, p + o[FC1_W], HID, 0, 0);
  layer_norm_rows<C>(X1, L::LF, TR, p + o[N2_W], p + o[N2_B], 1e-5f, false,
                     [&](int r, int c, float v) {
                       Y2[r * L::LT + c] = N::from_float(v);
                       put(O_Y2, r, c, v);
                     });
  const T* fc1_b = p + o[FC1_B];
  const uint32_t kmlp1 = skey(a, b, M_MLP1);
  for (int nb = 0; nb < HID / C; ++nb) {  // fc1's four column blocks
    ready();
    tc::gemm<T, NB>(MT, C / 8, C, RowMajor<T>{Y2, L::LT},
                    RowMajor<T>{WS, L::LT}, [&](int r, int cc, float v) {
                      const int n = r0 + r, c = nb * C + cc;
                      const float pre = v + ld(fc1_b + c);
                      const float mk = drop(kmlp1, n * HID + c, a.mlp);
                      if (dump && r < nr)
                        a.masks[ex.mlp1 + ((size_t)b * Nv + n) * HID + c] =
                            mk;
                      const float h1 = gelu_exact(pre) * mk;
                      H1D[r * L::LTH + c] = N::from_float(h1);
                      put(O_H1D, r, c, h1);
                    });
    __syncthreads();
    if (nb + 1 < HID / C)
      load_w(WS, p + o[FC1_W], HID, 0, (nb + 1) * C);
    else
      load_w(WS, p + o[FC2_W], C, 0, 0);
  }
  // x2 = x1 + DropPath2(MlpDrop(h1d @ fc2 + b)), fc2's four row blocks
  // summed in X2
  const T* fc2_b = p + o[FC2_B];
  const float dp2 = drop(skey(a, b, M_DP2), 0, a.path);
  if (dump && tile == 0 && tid == 0) a.masks[ex.dp2 + b] = dp2;
  const uint32_t kmlp2 = skey(a, b, M_MLP2);
  for (int kb = 0; kb < HID / C; ++kb) {
    ready();
    tc::gemm<T, NB>(MT, C / 8, C, RowMajor<T>{H1D + kb * C, L::LTH},
                    RowMajor<T>{WS, L::LT}, [&](int r, int c, float v) {
                      float* x2 = X2 + r * L::LF + c;
                      const float acc = kb == 0 ? v : *x2 + v;
                      if (kb + 1 < HID / C) {
                        *x2 = acc;
                        return;
                      }
                      const int n = r0 + r;
                      const float mk = drop(kmlp2, n * C + c, a.mlp);
                      if (dump && r < nr)
                        a.masks[ex.mlp2 + ((size_t)b * Nv + n) * C + c] = mk;
                      *x2 = X1[r * L::LF + c] +
                            (acc + ld(fc2_b + c)) * mk * dp2;
                    });
    __syncthreads();
    if (kb + 1 < HID / C) load_w(WS, p + o[FC2_W], C, (kb + 1) * C, 0);
  }
  layer_norm_rows<C>(X2, L::LF, TR, p + o[A2W], p + o[B2W], 1e-6f, true,
                     [&](int r, int c, float v) {
                       Y3[r * L::LT + c] = N::from_float(v);
                       if (!fwd)
                         put(O_Y3, r, c, v);
                       else if (r < nr)
                         a.y3[(row0 + r) * C + c] = v;
                     });
  if (!fwd) return;
  T* const outs[3] = {a.q2, a.k2, a.v2};
  for (int i = 0; i < 3; ++i) {
    __syncthreads();
    load_w(WS, p + o[L0_W + 2 * i], C, 0, 0);
    ready();
    const T* bias = p + o[L0_B + 2 * i];
    T* dst = outs[i] + row0 * C;
    tc::gemm<T, NB>(MT, C / 8, C, RowMajor<T>{Y3, L::LT},
                    RowMajor<T>{WS, L::LT}, [&](int r, int c, float v) {
                      if (r < nr) dst[r * C + c] = N::from_float(v + ld(bias + c));
                    });
  }
}

// lbf_rows_fwd: each CTA walks a contiguous run of (sample, tile) items
template <typename T>
__global__ void __launch_bounds__(NT, Rows<T>::MIN_CTAS)
    lbf_rows_fwd_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int total = a.B * a.nrt;
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int end = min(total, (int)(blockIdx.x + 1) * per);
  int jb = -1;
  for (int t = blockIdx.x * per; t < end; ++t)
    rows_fwd<T>(a, sm, t / a.nrt, t % a.nrt, true, jb);
}

// ---- the self-attention launches, on attn_tc.cuh ----------------------

// Staged K/V (or Q/dA) rows of both heads, 64 wide, in T; the forward's
// epilogue reuses the first key tile's room for T(a2) and L3's weights.
// Two CTAs per SM in bf16 (at most 128 registers a thread).
template <typename T>
struct Sa {
  using Pad = attn::Pad<T, C>;
  static constexpr int LK = Pad::LK, LV = Pad::LV;
  static constexpr int MIN_CTAS = sizeof(T) == 2 ? 2 : 1;
};

// the A fragments of 16 rows x one head (row m at p + m * C, zero from row
// nr on) for D-wide products
template <typename T>
__device__ __forceinline__ void row_frags(attn::QFrags<T, D>& f, const T* p,
                                          int nr) {
  using P = tc::Mma<T>;
  auto get = [&](int m, int d) { return m < nr ? ld(p + m * C + d) : 0.0f; };
#pragma unroll
  for (int ks = 0; ks < attn::ksteps<T, D>(); ++ks)
    f[ks] = P::load_a(get, 0, ks * P::KS);
}

// lbf_sa_fwd: per (64-query tile, sample), eight warps, four per head of
// 16 query rows: two_pass with the self mask and the log-sum-exp, then
// out = y3 + OutDrop(T(a2) L3 + b) on the tensor cores.
template <typename T>
__global__ void __launch_bounds__(NT, Sa<T>::MIN_CTAS)
    lbf_sa_fwd_kernel(Args<T> a, int kc) {
  using S = Sa<T>;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char sm[];
  T* Ks = reinterpret_cast<T*>(sm);
  T* Vs = Ks + kc * S::LK;
  const int Nv = a.Nv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = warp / 4, wr = (warp % 4) * 16;
  const int b = blockIdx.y, r0 = blockIdx.x * TQ, m0 = r0 + wr;
  const bool active = m0 < Nv;
  const size_t base = (size_t)b * Nv;
  const bool dump = a.masks != nullptr;
  const Export<T> ex(a);
  const uint32_t key = skey(a, b, M_SELF0 + h);

  attn::QFrags<T, D> qf;
  row_frags<T>(qf, a.q2 + (base + m0) * C + h * D, Nv - m0);
  // base-2 logits; -inf past the last key
  auto finish = [&](float (&s)[8][4], int key0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] *= SL;
    if (key0 + attn::KT > Nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (key0 + 8 * j + 2 * t + (i & 1) >= Nv) s[j][i] = -CUDART_INF_F;
    }
  };
  auto stats = [&](const float (&mx)[2], const float (&sum)[2]) {
    if (t != 0) return;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = m0 + g + 8 * rr;
      if (row < Nv)
        a.lse[((size_t)b * H + h) * Nv + row] = mx[rr] + log2f(sum[rr]);
    }
  };
  // the self mask times the normalised probabilities, before they are
  // rounded to T (the JAX kernel's pd.astype(dtype))
  auto keep = [&](float (&p)[8][4], int key0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + g + 8 * (i >> 1);
        const int col = key0 + 8 * j + 2 * t + (i & 1);
        const float mk = drop(key, (uint32_t)(row * Nv + col), a.self_);
        p[j][i] *= mk;
        if (dump && row < Nv && col < Nv)
          a.masks[ex.self_ + (((size_t)b * H + h) * Nv + row) * Nv + col] =
              mk;
      }
  };
  float o[NO][4];
  attn::two_pass<T, D, C>(
      o, qf, Ks + h * D, Vs + h * D, Nv, kc, active,
      [&](int key0, int n, bool with_v) {
        attn::stage_kv<T, C>(Ks, Vs, a.k2 + base * C, a.v2 + base * C, C, C,
                             key0, n, with_v);
      },
      finish, stats, keep);

  // a2 in f32 (the backward's D reads it unrounded)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = m0 + g + 8 * rr;
    if (row < Nv) {
      float* dst = a.a2 + (base + row) * C + h * D + 2 * t;
#pragma unroll
      for (int jn = 0; jn < NO; ++jn)
        st2(dst + 8 * jn, o[jn][2 * rr], o[jn][2 * rr + 1]);
    }
  }
  // out = y3 + OutDrop(T(a2) @ L3 + b): T(a2) and L3 into the staging room
  __syncthreads();  // K and V are read no more
  T* O = Ks;
  T* W3 = O + TQ * S::LK;
  tc::stage(W3, S::LV, a.w + a.offs[L3_W], C, C, C);
  tc::cp_async_commit();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    T* orow = O + (wr + g + 8 * rr) * S::LK + h * D + 2 * t;
#pragma unroll
    for (int jn = 0; jn < NO; ++jn) {
      orow[8 * jn] = Num<T>::from_float(o[jn][2 * rr]);
      orow[8 * jn + 1] = Num<T>::from_float(o[jn][2 * rr + 1]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  const int nq = min(TQ, Nv - r0);
  const T* l3_b = a.w + a.offs[L3_B];
  const uint32_t kout = skey(a, b, M_OUT);
  tc::gemm<T, 2>(TQ / 16, C / 8, C, RowMajor<T>{O, S::LK},
                 RowMajor<T>{W3, S::LV}, [&](int m, int c, float v, float w) {
                   if (m >= nq) return;
                   const int n = r0 + m;
                   const size_t i = (base + n) * C + c;
                   const float k0 = drop(kout, n * C + c, a.outd);
                   const float k1 = drop(kout, n * C + c + 1, a.outd);
                   if (dump) {
                     a.masks[ex.out + i] = k0;
                     a.masks[ex.out + i + 1] = k1;
                   }
                   const float2 y = ld2(a.y3 + i), bb = ld2(l3_b + c);
                   st2(a.out + i, y.x + (v + bb.x) * k0, y.y + (w + bb.y) * k1);
                 });
}

// lbf_sa_bwd_dq's prologue buffers (bytes), in the room the K/V chunks
// take afterwards: L3's weights, T(dsa), T(da2) (rows C + 16 / sizeof(T)
// apart), f32 dsa and a2, D per head.
template <typename T>
struct DqSmem {
  static constexpr int LT = C + 16 / (int)sizeof(T), LF = C + 4;
  static constexpr int TB = TQ * LT * (int)sizeof(T);
  static constexpr int W3 = 0, G = W3 + TB, DA = G + TB, DSF = DA + TB,
                       A2F = DSF + TQ * LF * 4, DD = A2F + TQ * LF * 4,
                       BYTES = DD + H * TQ * 4;
  static int bytes(int kc) {
    return cmax(BYTES, kc * attn::Pad<T, C>::KEY_BYTES);
  }
};

// lbf_sa_bwd_dq: per (64-query tile, sample), warps as in lbf_sa_fwd.
// First the tile's share of L3's backward (out = y3 + m_out * (a2 L3 + b)):
// dsa = g * m_out, L3's bias share, T(a2) and T(dsa) to `ops`, da2 =
// T(dsa) L3^T (to da2 in T), D = <T(da2), a2> per head; then, in steps of
// 8 QSTEP keys, S = q k^T and dP = dA v^T in registers, P = exp2(S SL -
// lse2) (0 past the last key), dS = T(P (M dP - D) scale), dq += dS k.
template <typename T>
__global__ void __launch_bounds__(NT, Sa<T>::MIN_CTAS)
    lbf_sa_bwd_dq_kernel(Args<T> a, int kc) {
  using P = tc::Mma<T>;
  using S = Sa<T>;
  using L = DqSmem<T>;
  using N = Num<T>;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char sm[];
  const int Nv = a.Nv, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = warp / 4, wr = (warp % 4) * 16;
  const int b = blockIdx.y, r0 = blockIdx.x * TQ, m0 = r0 + wr;
  const int nq = min(TQ, Nv - r0);
  const bool active = m0 < Nv;
  const size_t base = (size_t)b * Nv, row0 = base + r0;
  T* W3 = at<T>(sm, L::W3);
  T* G = at<T>(sm, L::G);
  T* DA = at<T>(sm, L::DA);
  float* DSF = at<float>(sm, L::DSF);
  float* A2F = at<float>(sm, L::A2F);
  float* DD = at<float>(sm, L::DD);

  tc::stage(W3, L::LT, a.w + a.offs[L3_W], C, C, C);
  tc::cp_async_commit();
  const uint32_t kout = skey(a, b, M_OUT);
  for (int i = tid; i < TQ * C; i += NT) {
    const int r = i / C, c = i % C;
    float v = 0.0f, a2 = 0.0f;
    if (r < nq) {
      const size_t e = (row0 + r) * C + c;
      v = N::to_float(a.gout[e]) * drop(kout, (r0 + r) * C + c, a.outd);
      a2 = a.a2[e];
      T* op = a.ops + (row0 + r) * O_W;
      op[O_DSA + c] = N::from_float(v);
      op[O_A2 + c] = N::from_float(a2);
    }
    DSF[r * L::LF + c] = v;
    A2F[r * L::LF + c] = a2;
    G[r * L::LT + c] = N::from_float(v);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  if (tid < C) {  // this tile's share of L3's bias gradient, rows in order
    float s = 0.0f;
    for (int r = 0; r < nq; ++r) s += DSF[r * L::LF + tid];
    a.l3b[((size_t)b * a.nqt + blockIdx.x) * C + tid] = s;
  }
  tc::gemm<T, 2>(TQ / 16, C / 8, C, RowMajor<T>{G, L::LT},
                 ColMajor<T>{W3, L::LT}, [&](int m, int c, float v, float w) {
                   st2(DA + m * L::LT + c, v, w);
                   if (m < nq) st2(a.da2 + (row0 + m) * C + c, v, w);
                 });
  __syncthreads();
  // D per (row, head): two threads a pair, half the head's columns each
  {
    static_assert(2 * TQ * H == NT, "a thread pair per (row, head)");
    const int r = tid / (2 * H), hh = tid / 2 % H, half = tid & 1;
    const int c0 = hh * D + half * (D / 2);
    float v = 0.0f;
#pragma unroll
    for (int c = c0; c < c0 + D / 2; ++c)
      v += N::to_float(DA[r * L::LT + c]) * A2F[r * L::LF + c];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    if (half == 0) {
      DD[hh * TQ + r] = v;
      if (r < nq) a.dd[((size_t)b * H + hh) * Nv + r0 + r] = v;
    }
  }
  __syncthreads();
  attn::QFrags<T, D> qf, df;
  row_frags<T>(qf, a.q2 + (base + m0) * C + h * D, Nv - m0);
#pragma unroll
  for (int ks = 0; ks < attn::ksteps<T, D>(); ++ks)
    df[ks] = P::load_a(RowMajor<T>{DA + wr * L::LT + h * D, L::LT}, 0,
                       ks * P::KS);
  float lse[2], dd[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = min(m0 + g + 8 * rr, Nv - 1);
    lse[rr] = a.lse[((size_t)b * H + h) * Nv + row];
    dd[rr] = DD[h * TQ + wr + g + 8 * rr];
  }
  const uint32_t key = skey(a, b, M_SELF0 + h);
  float dq[NO][4] = {};
  T* Ks = reinterpret_cast<T*>(sm);
  T* Vs = Ks + kc * S::LK;
  for (int key0 = 0; key0 < Nv; key0 += kc) {
    const int n = min(kc, Nv - key0);
    __syncthreads();  // the prologue's buffers, or the last chunk, are dead
    attn::stage_kv<T, C>(Ks, Vs, a.k2 + base * C, a.v2 + base * C, C, C,
                         key0, n, true);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int kt = 0; kt < n; kt += 8 * QSTEP) {
      float s[QSTEP][4], dp[QSTEP][4];
      attn::scores<T, D, S::LK, QSTEP>(s, qf, Ks + kt * S::LK + h * D);
      attn::scores<T, D, S::LV, QSTEP>(dp, df, Vs + kt * S::LV + h * D);
#pragma unroll
      for (int j = 0; j < QSTEP; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + g + 8 * (i >> 1);
          const int col = key0 + kt + 8 * j + 2 * t + (i & 1);
          const float p =
              col < Nv ? exp2f(s[j][i] * SL - lse[i >> 1]) : 0.0f;
          const float mk = drop(key, (uint32_t)(row * Nv + col), a.self_);
          s[j][i] = rnd<T>(p * (mk * dp[j][i] - dd[i >> 1]) * SCALE);
        }
      attn::pv<T, NO, S::LK, QSTEP>(dq, s, Ks + kt * S::LK + h * D);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = m0 + g + 8 * rr;
    if (row < Nv) {
      float* dst = a.dq2 + (base + row) * C + h * D + 2 * t;
#pragma unroll
      for (int jn = 0; jn < NO; ++jn)
        st2(dst + 8 * jn, dq[jn][2 * rr], dq[jn][2 * rr + 1]);
    }
  }
}

// lbf_sa_bwd_dkv's staging per query: Q and dA rows of both heads in T,
// lse2 and D per head
template <typename T>
struct Dkv {
  static constexpr int QUERY_BYTES =
      attn::Pad<T, C>::KEY_BYTES + 2 * H * (int)sizeof(float);
};

// queries per staged chunk of lbf_sa_bwd_dkv: all of them (rounded up to
// 64) where they fit the CTA's share of the SM, else the most that do
template <typename T>
int dkv_chunk(int nv) {
  const int whole = round_up(nv, attn::KT);
  const int fit =
      attn::SMEM_PER_CTA / Dkv<T>::QUERY_BYTES / attn::KT * attn::KT;
  return whole < fit ? whole : fit;
}

// lbf_sa_bwd_dkv: per (64-key tile, sample), eight warps, four per head
// of 16 keys whose k and v stay in registers; over the queries in steps of
// 8 QSTEP: S^T = k q^T, dP^T = v dA^T, P = exp2(S SL - lse2) (0 past the
// last query, whose lse2 is staged as +inf), the mask regenerated from
// the hash at (query * Nv + key), dv += T(P M)^T dA, dk += dS^T q.
template <typename T>
__global__ void __launch_bounds__(NT, Sa<T>::MIN_CTAS)
    lbf_sa_bwd_dkv_kernel(Args<T> a, int kc) {
  using S = Sa<T>;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char sm[];
  T* Qs = reinterpret_cast<T*>(sm);
  T* As = Qs + kc * S::LK;
  float* LS = reinterpret_cast<float*>(As + kc * S::LV);  // [H][kc]
  float* DS = LS + H * kc;
  const int Nv = a.Nv, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = warp / 4, wr = (warp % 4) * 16;
  const int b = blockIdx.y, m0 = blockIdx.x * TQ + wr;
  const bool active = m0 < Nv;
  const size_t base = (size_t)b * Nv;
  attn::QFrags<T, D> kf, vf;
  row_frags<T>(kf, a.k2 + (base + m0) * C + h * D, Nv - m0);
  row_frags<T>(vf, a.v2 + (base + m0) * C + h * D, Nv - m0);
  const uint32_t key = skey(a, b, M_SELF0 + h);
  float dk[NO][4] = {}, dv[NO][4] = {};
  for (int q0 = 0; q0 < Nv; q0 += kc) {
    const int n = min(kc, Nv - q0), nr = round_up(n, attn::KT);
    __syncthreads();  // the last chunk is read no more
    attn::stage_kv<T, C>(Qs, As, a.q2 + base * C, a.da2 + base * C, C, C,
                         q0, n, true);
    for (int i = tid; i < H * nr; i += NT) {
      const int hh = i / nr, qq = i % nr;
      const size_t e = ((size_t)b * H + hh) * Nv + q0 + qq;
      LS[hh * kc + qq] = qq < n ? a.lse[e] : CUDART_INF_F;
      DS[hh * kc + qq] = qq < n ? a.dd[e] : 0.0f;
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    const float* ls = LS + h * kc;
    const float* ds = DS + h * kc;
    for (int qt = 0; qt < n; qt += 8 * QSTEP) {
      float s[QSTEP][4], dp[QSTEP][4];
      attn::scores<T, D, S::LK, QSTEP>(s, kf, Qs + qt * S::LK + h * D);
      attn::scores<T, D, S::LV, QSTEP>(dp, vf, As + qt * S::LV + h * D);
#pragma unroll
      for (int j = 0; j < QSTEP; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qq = qt + 8 * j + 2 * t + (i & 1);
          const int col = m0 + g + 8 * (i >> 1);
          const float p = exp2f(s[j][i] * SL - ls[qq]);
          const float mk =
              drop(key, (uint32_t)((q0 + qq) * Nv + col), a.self_);
          s[j][i] = rnd<T>(p * mk);
          dp[j][i] = rnd<T>(p * (mk * dp[j][i] - ds[qq]) * SCALE);
        }
      attn::pv<T, NO, S::LV, QSTEP>(dv, s, As + qt * S::LV + h * D);
      attn::pv<T, NO, S::LK, QSTEP>(dk, dp, Qs + qt * S::LK + h * D);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = m0 + g + 8 * rr;
    if (row < Nv) {
      const size_t e = (base + row) * C + h * D + 2 * t;
#pragma unroll
      for (int jn = 0; jn < NO; ++jn) {
        st2(a.dk2 + e + 8 * jn, dk[jn][2 * rr], dk[jn][2 * rr + 1]);
        st2(a.dv2 + e + 8 * jn, dv[jn][2 * rr], dv[jn][2 * rr + 1]);
      }
    }
  }
}


// The row-local backward of one (sample, tile), after rows_fwd: dx, this
// tile's shares of the joints' dk/dv, the bias and norm gradients into the
// CTA's partial row PG (at roff), and the cotangent operands of the weight
// gradients to `ops` (lbf_wgrad forms the products).
template <typename T>
__device__ void rows_bwd(const Args<T>& a, unsigned char* sm, float* PG,
                         int b, int tile) {
  using L = Rows<T>;
  using N = Num<T>;
  constexpr int MT = TR / 16, NB = TR / 16;
  const int Nv = a.Nv, J = a.J;
  const int r0 = tile * TR;
  const int nr = min(TR, Nv - r0);
  const size_t row0 = (size_t)b * Nv + r0;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  const float* X = at<float>(sm, L::X);
  const float* P = at<float>(sm, L::P);
  const float* X1 = at<float>(sm, L::X1);
  const float* X2 = at<float>(sm, L::X2);
  const T* Q = at<T>(sm, L::Q);
  const T* PM = at<T>(sm, L::PM);
  const T* Y2 = at<T>(sm, L::Y2);
  const T* KJ = at<T>(sm, L::KJ);
  const T* VJ = at<T>(sm, L::VJ);
  float* STATS = at<float>(sm, L::STATS);
  float* S0 = at<float>(sm, L::S0);  // dy3, then dy2, then ds
  float* DX = at<float>(sm, L::S1);  // dx2, then dx1
  float* S2 = at<float>(sm, L::S2);  // dh2, then do, then dyv
  float* RR = at<float>(sm, L::R);   // pre-activation, then dh1
  T* D3 = at<T>(sm, L::R);           // dq2 | dk2 | dv2, before RR
  T* DA1 = at<T>(sm, L::R);          // after RR
  T* DQ = at<T>(sm, L::R + L::TB);
  T* WS = at<T>(sm, L::WS);
  const float scale = rsqrtf((float)D);
  auto put = [&](int col, int r, int c, float v) {
    if (r < nr) a.ops[(row0 + r) * O_W + col + c] = N::from_float(v);
  };

  __syncthreads();  // the forward's transient buffers are dead
  // out = y3 + ...: dy3 = g + [dq2 dk2 dv2] [L0; L1; L2]^T, one weight
  // at a time
  load_w(WS, p + o[L0_W], C, 0, 0);
  for (int i = tid; i < TR * 3 * C; i += NT) {
    const int r = i / (3 * C), c = i % (3 * C);
    const float* src = c < C ? a.dq2 : c < 2 * C ? a.dk2 : a.dv2;
    const float v = r < nr ? src[(row0 + r) * C + c % C] : 0.0f;
    D3[r * L::LT3 + c] = N::from_float(v);
    put(O_DQ2, r, c, v);
  }
  for (int i = tid; i < TR * C; i += NT) {
    const int r = i / C, c = i % C;
    S0[r * L::LF + c] = r < nr ? N::to_float(a.gout[(row0 + r) * C + c]) : 0.0f;
  }
  colsum_acc(a.dq2 + row0 * C, C, nr, C, PG + roff(L0_B));
  colsum_acc(a.dk2 + row0 * C, C, nr, C, PG + roff(L1_B));
  colsum_acc(a.dv2 + row0 * C, C, nr, C, PG + roff(L2_B));
  for (int i = 0; i < 3; ++i) {
    ready();
    tc::gemm<T, NB>(MT, C / 8, C, RowMajor<T>{D3 + i * C, L::LT3},
                    ColMajor<T>{WS, L::LT},
                    [&](int r, int c, float v) { S0[r * L::LF + c] += v; });
    __syncthreads();
    if (i < 2) load_w(WS, p + o[L0_W + 2 * (i + 1)], C, 0, 0);
  }
  // y3 = StdLN(x2)
  stdln_bwd_rows<C>(S0, L::LF, X2, L::LF, TR, p + o[A2W], 1e-6f, STATS,
                    [&](int r, int c, float v) { DX[r * L::LF + c] = v; });
  __syncthreads();
  norm_param_acc(S0, L::LF, X2, L::LF, STATS, nr, C, PG + roff(A2W),
                 PG + roff(B2W));
  load_w(WS, p + o[FC1_W], HID, 0, 0);
  // x2 = x1 + dp2 * m2 * h2
  const float dp2 = drop(skey(a, b, M_DP2), 0, a.path);
  const uint32_t kmlp2 = skey(a, b, M_MLP2);
  for (int i = tid; i < TR * C; i += NT) {
    const int r = i / C, c = i % C;
    const float v = DX[r * L::LF + c] * dp2 *
                    drop(kmlp2, (r0 + r) * C + c, a.mlp);
    S2[r * L::LF + c] = v;
    put(O_DH2, r, c, v);
  }
  ready();
  colsum_acc(S2, L::LF, nr, C, PG + roff(FC2_B));
  // MLP: the pre-activation again (the forward's chain, the same values),
  // then dh1 = (dh2 fc2^T) * m1 * gelu'(pre) in its place, by 64 columns
  const T* fc1_b = p + o[FC1_B];
  for (int nb = 0; nb < HID / C; ++nb) {
    if (nb > 0) ready();
    tc::gemm<T, NB>(MT, C / 8, C, RowMajor<T>{Y2, L::LT},
                    RowMajor<T>{WS, L::LT}, [&](int r, int c, float v) {
                      RR[r * L::LFH + nb * C + c] = v + ld(fc1_b + nb * C + c);
                    });
    __syncthreads();
    if (nb + 1 < HID / C)
      load_w(WS, p + o[FC1_W], HID, 0, (nb + 1) * C);
    else
      load_w(WS, p + o[FC2_W], C, 0, 0);
  }
  const uint32_t kmlp1 = skey(a, b, M_MLP1);
  for (int nb = 0; nb < HID / C; ++nb) {
    ready();
    tc::gemm<T, NB>(MT, C / 8, C, RowMajor<float>{S2, L::LF},
                    ColMajor<T>{WS, L::LT}, [&](int r, int kk, float v) {
                      const int k = nb * C + kk;
                      float* e = RR + r * L::LFH + k;
                      const float d =
                          v * drop(kmlp1, (r0 + r) * HID + k, a.mlp) *
                          gelu_grad(*e);
                      *e = d;
                      put(O_DH1, r, k, d);
                    });
    __syncthreads();
    if (nb + 1 < HID / C)
      load_w(WS, p + o[FC2_W], C, (nb + 1) * C, 0);
    else
      load_w(WS, p + o[FC1_W], HID, 0, 0);
  }
  colsum_acc(RR, L::LFH, nr, HID, PG + roff(FC1_B));
  // dy2 = dh1 fc1^T, fc1's four column blocks summed in S0
  for (int kb = 0; kb < HID / C; ++kb) {
    ready();
    tc::gemm<T, NB>(MT, C / 8, C, RowMajor<float>{RR + kb * C, L::LFH},
                    ColMajor<T>{WS, L::LT}, [&](int r, int k, float v) {
                      float* e = S0 + r * L::LF + k;
                      *e = kb == 0 ? v : *e + v;
                    });
    __syncthreads();
    if (kb + 1 < HID / C) load_w(WS, p + o[FC1_W], HID, 0, (kb + 1) * C);
  }
  ln_bwd_rows<C>(S0, L::LF, X1, L::LF, TR, p + o[N2_W], 1e-5f, STATS,
                 [&](int r, int c, float v) { DX[r * L::LF + c] += v; });
  __syncthreads();
  norm_param_acc(S0, L::LF, X1, L::LF, STATS, nr, C, PG + roff(N2_W),
                 PG + roff(N2_B));
  load_w(WS, p + o[PROJ_W], C, 0, 0);
  // x1 = x + dp1 * mproj * (a1 @ proj + b)
  const float dp1 = drop(skey(a, b, M_DP1), 0, a.path);
  const uint32_t kproj = skey(a, b, M_PROJ);
  for (int i = tid; i < TR * C; i += NT) {
    const int r = i / C, c = i % C;
    const float v = DX[r * L::LF + c] * dp1 *
                    drop(kproj, (r0 + r) * C + c, a.proj);
    S2[r * L::LF + c] = v;
    put(O_DO, r, c, v);
  }
  ready();
  colsum_acc(S2, L::LF, nr, C, PG + roff(PROJ_B));
  tc::gemm<T, NB>(MT, C / 8, C, RowMajor<float>{S2, L::LF},
                  ColMajor<T>{WS, L::LT}, [&](int r, int k, float v) {
                    DA1[r * L::LT + k] = N::from_float(v);
                  });
  __syncthreads();
  load_w(WS, p + o[WQ], C, 0, 0);
  // cross-attention backward: dprob = m * (da . v) per (row, head, key),
  // then ds = p * (dprob - <dprob, p>) * scale per (row, head)
  for (int h = 0; h < H; ++h) {
    const uint32_t key = skey(a, b, M_ATTN0 + h);
    tc::gemm<T, 1>(MT, JMAX / 8, D, RowMajor<T>{DA1 + h * D, L::LT},
                   ColMajor<T>{VJ + h * D, L::LT}, [&](int r, int m, float v) {
                     S0[r * L::LF + h * JMAX + m] =
                         m < J ? v * drop(key, (r0 + r) * J + m, a.attn)
                               : 0.0f;
                   });
  }
  __syncthreads();
  for (int task = tid; task < H * TR; task += NT) {
    const int h = task / TR;
    const int r = task % TR;
    const float* prow = P + r * L::LF + h * JMAX;
    float* dsrow = S0 + r * L::LF + h * JMAX;
    float dot = 0.0f;
    for (int m = 0; m < J; ++m) dot = fmaf(dsrow[m], prow[m], dot);
    for (int m = 0; m < JMAX; ++m)
      dsrow[m] = m < J ? prow[m] * (dsrow[m] - dot) * scale : 0.0f;
  }
  __syncthreads();
  // dq, and this tile's share of the joints' dk and dv
  float* djk = a.djk + (((size_t)b * a.nrt + tile) * J) * C;
  float* djv = a.djv + (((size_t)b * a.nrt + tile) * J) * C;
  for (int h = 0; h < H; ++h) {
    tc::gemm<T, 1>(MT, D / 8, JMAX, RowMajor<float>{S0 + h * JMAX, L::LF},
                   RowMajor<T>{KJ + h * D, L::LT}, [&](int r, int c, float v) {
                     DQ[r * L::LT + h * D + c] = N::from_float(v);
                     put(O_DQ, r, h * D + c, v);
                   });
    tc::gemm<T, 1>(JMAX / 16, D / 8, TR, ColMajor<float>{S0 + h * JMAX, L::LF},
                   RowMajor<T>{Q + h * D, L::LT}, [&](int m, int c, float v) {
                     if (m < J) djk[m * C + h * D + c] = v;
                   });
    tc::gemm<T, 1>(JMAX / 16, D / 8, TR, ColMajor<T>{PM + h * JMAX, L::LT},
                   RowMajor<T>{DA1 + h * D, L::LT}, [&](int m, int c, float v) {
                     if (m < J) djv[m * C + h * D + c] = v;
                   });
  }
  ready();
  tc::gemm<T, NB>(MT, C / 8, C, RowMajor<T>{DQ, L::LT},
                  ColMajor<T>{WS, L::LT},
                  [&](int r, int k, float v) { S2[r * L::LF + k] = v; });
  __syncthreads();
  ln_bwd_rows<C>(S2, L::LF, X, L::LF, TR, p + o[N1_W], 1e-5f, STATS,
                 [&](int r, int c, float v) {
                   if (r < nr)
                     a.dx[(row0 + r) * C + c] =
                         N::from_float(DX[r * L::LF + c] + v);
                 });
  __syncthreads();
  norm_param_acc(S2, L::LF, X, L::LF, STATS, nr, C, PG + roff(N1_W),
                 PG + roff(N1_B));
}

template <typename T>
__global__ void __launch_bounds__(NT, Rows<T>::MIN_CTAS)
    lbf_rows_bwd_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char sm[];
  float* PG = a.pr + (size_t)blockIdx.x * NR;
  for (int i = threadIdx.x; i < NR; i += NT) PG[i] = 0.0f;  // rows_fwd syncs
  const int total = a.B * a.nrt;
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int end = min(total, (int)(blockIdx.x + 1) * per);
  int jb = -1;
  for (int t = blockIdx.x * per; t < end; ++t) {
    const int b = t / a.nrt, tile = t % a.nrt;
    rows_fwd<T>(a, sm, b, tile, false, jb);
    rows_bwd<T>(a, sm, PG, b, tile);
  }
}

// lbf_wgrad's products: G[k][n] = sum_r ops[r][ca + k] * ops[r][cb + n],
// a 64 x 64 tile of field `field`, at element g0 of it, rows ldg apart;
// the 14 tiles cover the eight weight fields of a partial row (woff)
struct WJob {
  int ca, cb, field, g0, ldg;
};

constexpr int NWJOB = 14;

__device__ __forceinline__ WJob wjob(int j) {
  if (j < 3) return {O_Y3, O_DQ2 + C * j, L0_W + 2 * j, 0, C};
  if (j < 7) return {O_H1D + C * (j - 3), O_DH2, FC2_W, C * C * (j - 3), C};
  if (j < 11) return {O_Y2, O_DH1 + C * (j - 7), FC1_W, C * (j - 7), HID};
  if (j == 11) return {O_A1, O_DO, PROJ_W, 0, C};
  if (j == 12) return {O_YV, O_DQ, WQ, 0, C};
  return {O_A2, O_DSA, L3_W, 0, C};
}

constexpr int WR = 64;  // rows of ops per staged chunk

// One CTA per (64 x 64 tile, chunk of `per` rows): the chunk's rows staged
// through shared memory in a two-deep cp.async ring, each 64 rows' sum on
// the tensor cores and the running sum in f32 registers (rounded to
// nearest: the tensor cores' accumulation does not round so, and a chunk
// of thousands of rows would drift), in a fixed order; the tile written
// to the chunk's partial row of `pw`.
template <typename T>
__global__ void __launch_bounds__(NT) lbf_wgrad_kernel(
    const T* __restrict__ ops, float* pw, int R, int per) {
  using Pm = tc::Mma<T>;
  constexpr int LD = C + 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char sm[];
  T* As = reinterpret_cast<T*>(sm);  // [2][WR][LD]
  T* Bs = As + 2 * WR * LD;
  const WJob job = wjob(blockIdx.x);
  const int rb = blockIdx.y * per, re = min(R, rb + per);
  const int nchunk = re > rb ? (re - rb + WR - 1) / WR : 0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  auto fetch = [&](int buf, int c) {
    const int r = rb + c * WR, n = min(WR, re - r);
    T* A = As + buf * WR * LD;
    T* B = Bs + buf * WR * LD;
    tc::stage(A, LD, ops + (size_t)r * O_W + job.ca, O_W, n, C);
    tc::stage(B, LD, ops + (size_t)r * O_W + job.cb, O_W, n, C);
    for (int i = threadIdx.x; i < (WR - n) * C; i += NT) {
      A[(n + i / C) * LD + i % C] = Num<T>::from_float(0.0f);
      B[(n + i / C) * LD + i % C] = Num<T>::from_float(0.0f);
    }
    tc::cp_async_commit();
  };
  float tot[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[j][i] = 0.0f;
  if (nchunk > 0) fetch(0, 0);
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) {
      fetch((c + 1) & 1, c + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const ColMajor<T> fa{As + (c & 1) * WR * LD, LD};
    const RowMajor<T> fb{Bs + (c & 1) * WR * LD, LD};
    float acc[4][4] = {};
    for (int k0 = 0; k0 < WR; k0 += Pm::KS) {
      const typename Pm::A A = Pm::load_a(fa, m0, k0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Pm::mma(acc[j], A, Pm::load_b(fb, k0, n0 + 8 * j));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[j][i] += acc[j][i];
    __syncthreads();
  }
  float* G = pw + (size_t)blockIdx.y * NW + woff(job.field) + job.g0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    G[(m0 + g) * job.ldg + n] = tot[j][0];
    G[(m0 + g) * job.ldg + n + 1] = tot[j][1];
    G[(m0 + g + 8) * job.ldg + n] = tot[j][2];
    G[(m0 + g + 8) * job.ldg + n + 1] = tot[j][3];
  }
}

// lbf_joints_bwd's shared memory (bytes): wk and wv (T, staged once per
// CTA), per sample the joints' input (f32), LN1 (T), the summed dk and dv
// (T) and dyj (f32), JMAX rows each; the CTA's gradient sums (f32): wk,
// wv, then norm1's scale and bias and L3's bias, in the order of its
// partial row (jpoff); the LN rows' statistics.
template <typename T>
struct JointsSmem {
  static constexpr int LT = C + 16 / (int)sizeof(T), LF = C + 4;
  static constexpr int WB = C * LT * (int)sizeof(T);
  static constexpr int JTB = JMAX * LT * (int)sizeof(T);
  static constexpr int SWK = 0, SWV = SWK + WB, JT = SWV + WB,
                       YJ = JT + JMAX * LF * 4, DK = YJ + JTB, DV = DK + JTB,
                       DYJ = DV + JTB, GS = DYJ + JMAX * LF * 4,
                       STATS = GS + NJP * 4, BYTES = STATS + 2 * JMAX * 4;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Per sample (a grid-stride loop): the joints' dk and dv summed over the
// sample's row tiles in order, and L3's bias over its query tiles; LN1 of
// the joint rows again; wk/wv gradients yj^T [dk | dv] and dyj = dk wk^T +
// dv wv^T on the tensor cores; the LN1 backward -> djoints. The CTA's sums
// go to its partial row at the end.
template <typename T>
__global__ void __launch_bounds__(NT) lbf_joints_bwd_kernel(Args<T> a) {
  using L = JointsSmem<T>;
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char sm[];
  T* WKs = at<T>(sm, L::SWK);
  T* WVs = at<T>(sm, L::SWV);
  float* JT = at<float>(sm, L::JT);
  T* YJ = at<T>(sm, L::YJ);
  T* DK = at<T>(sm, L::DK);
  T* DV = at<T>(sm, L::DV);
  float* DYJ = at<float>(sm, L::DYJ);
  float* GS = at<float>(sm, L::GS);
  float* STATS = at<float>(sm, L::STATS);
  const int J = a.J, tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  tc::stage(WKs, L::LT, p + o[WK], C, C, C);
  tc::stage(WVs, L::LT, p + o[WV], C, C, C);
  tc::cp_async_commit();
  for (int i = tid; i < NJP; i += NT) GS[i] = 0.0f;
  tc::cp_async_wait<0>();
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    __syncthreads();  // the last sample is done with every buffer
    // each thread's JMAX * C / NT elements, four consecutive ones (i =
    // 4 (tid + NT k)) at a time, the tiles' shares summed in tile order with
    // several tiles' loads in flight
    {
      constexpr int PER = JMAX * C / (4 * NT);
      const int n = J * C;
      const float* pk = a.djk + (size_t)b * a.nrt * n;
      const float* pv = a.djv + (size_t)b * a.nrt * n;
      float4 sk[PER], sv[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) sk[k] = sv[k] = make_float4(0, 0, 0, 0);
#pragma unroll 3
      for (int t = 0; t < a.nrt; ++t) {
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int i = 4 * (tid + NT * k);
          if (i < n) {
            const float4 u = ld4(pk + (size_t)t * n + i);
            const float4 v = ld4(pv + (size_t)t * n + i);
            sk[k] = make_float4(sk[k].x + u.x, sk[k].y + u.y, sk[k].z + u.z,
                                sk[k].w + u.w);
            sv[k] = make_float4(sv[k].x + v.x, sv[k].y + v.y, sv[k].z + v.z,
                                sv[k].w + v.w);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = 4 * (tid + NT * k), r = i / C, c = i % C;
        const float ks[4] = {sk[k].x, sk[k].y, sk[k].z, sk[k].w};
        const float vs[4] = {sv[k].x, sv[k].y, sv[k].z, sv[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          JT[r * L::LF + c + e] =
              i < n ? N::to_float(a.jt[(size_t)b * n + i + e]) : 0.0f;
          DK[r * L::LT + c + e] = N::from_float(ks[e]);
          DV[r * L::LT + c + e] = N::from_float(vs[e]);
          if (i >= n) YJ[r * L::LT + c + e] = N::from_float(0.0f);
        }
      }
    }
    if (tid < C) {
      float s = 0.0f;
      for (int t = 0; t < a.nqt; ++t)
        s += a.l3b[((size_t)b * a.nqt + t) * C + tid];
      GS[jpoff(L3_B) + tid] += s;
    }
    __syncthreads();
    layer_norm_rows<C>(JT, L::LF, J, p + o[N1_W], p + o[N1_B], 1e-5f, false,
                       [&](int r, int c, float v) {
                         YJ[r * L::LT + c] = N::from_float(v);
                       });
    __syncthreads();
    // one owner thread per element, the same for every sample
    for (int k = 0; k < 2; ++k) {
      float* G = GS + (k == 0 ? jpoff(WK) : jpoff(WV));
      tc::gemm<T, 2>(C / 16, C / 8, JMAX, ColMajor<T>{YJ, L::LT},
                     RowMajor<T>{k == 0 ? DK : DV, L::LT},
                     [&](int m, int n, float v, float w) {
                       G[m * C + n] += v;
                       G[m * C + n + 1] += w;
                     });
      tc::gemm<T, 2>(JMAX / 16, C / 8, C, RowMajor<T>{k == 0 ? DK : DV, L::LT},
                     ColMajor<T>{k == 0 ? WKs : WVs, L::LT},
                     [&](int r, int n, float v, float w) {
                       float* e = DYJ + r * L::LF + n;
                       if (k == 0) {
                         e[0] = v;
                         e[1] = w;
                       } else {
                         e[0] += v;
                         e[1] += w;
                       }
                     });
    }
    __syncthreads();
    ln_bwd_rows<C>(DYJ, L::LF, JT, L::LF, J, p + o[N1_W], 1e-5f, STATS,
                   [&](int r, int c, float v) {
                     a.djt[((size_t)b * J + r) * C + c] = N::from_float(v);
                   });
    __syncthreads();
    norm_param_acc(DYJ, L::LF, JT, L::LF, STATS, J, C, GS + jpoff(N1_W),
                   GS + jpoff(N1_B));
  }
  __syncthreads();
  float* PJ = a.pj + (size_t)blockIdx.x * NJP;
  for (int i = tid; i < NJP; i += NT) PJ[i] = GS[i];
}

// lbf_reduce's plan: for each gradient field, its length, where it goes in
// `grads`, and the (at most two) kinds of partial rows that hold it, as
// (first row's element 0 of the field, rows, row stride); and the first
// 32-wide strip of each field (a block each).
struct RSrc {
  const float* p;
  int rows, ld;
};

struct RField {
  int len, dst;
  RSrc src[2];
};

struct RPlan {
  RField f[NFIELD];
  int strip0[NFIELD + 1];
};

// Each block sums one 32-element strip of a field: warp w takes rows w,
// w + 8, ... of each source in turn (lane = element, four rows' loads in
// flight), then warp 0 adds the eight warps' sums in order. Fixed order:
// repeat runs are bit-identical.
__global__ void __launch_bounds__(256) lbf_reduce_kernel(const RPlan plan,
                                                         float* grads) {
  __shared__ float acc[8][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int f = 0;
  while ((int)blockIdx.x >= plan.strip0[f + 1]) ++f;
  const RField& F = plan.f[f];
  const int e = ((int)blockIdx.x - plan.strip0[f]) * 32 + lane;
  float s = 0.0f;
  if (e < F.len) {
    for (int k = 0; k < 2; ++k) {
      const RSrc src = F.src[k];
#pragma unroll 4
      for (int r = warp; r < src.rows; r += 8)
        s += src.p[(size_t)r * src.ld + e];
    }
  }
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < F.len) {
    float tot = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) tot += acc[w][lane];
    grads[F.dst + e] = tot;
  }
}

__host__ __device__ constexpr int field_len(int f) {
  return f == FC1_W || f == FC2_W ? C * HID
       : f == FC1_B ? HID
       : f == WQ || f == WK || f == WV || f == PROJ_W || f == L0_W ||
                 f == L1_W || f == L2_W || f == L3_W
           ? C * C
           : C;
}

// grads[offs[f] + e] = the sum of field f over every partial row holding
// it (offs: the fields' offsets, on the host)
inline int reduce_fields(const float* pw, int nc_w, const float* pr,
                         int nc_rows, const float* pj, int nc_j,
                         const int* offs, float* grads, cudaStream_t s) {
  RPlan plan{};
  int strips = 0;
  for (int f = 0; f < NFIELD; ++f) {
    RField& F = plan.f[f];
    F.len = field_len(f);
    F.dst = offs[f];
    int k = 0;
    if (woff(f) >= 0) F.src[k++] = {pw + woff(f), nc_w, NW};
    if (roff(f) >= 0) F.src[k++] = {pr + roff(f), nc_rows, NR};
    if (jpoff(f) >= 0) F.src[k++] = {pj + jpoff(f), nc_j, NJP};
    plan.strip0[f] = strips;
    strips += (F.len + 31) / 32;
  }
  plan.strip0[NFIELD] = strips;
  lbf_reduce_kernel<<<strips, 256, 0, s>>>(plan, grads);
  return (int)cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* x, const void* jt, const void* w,
                  const void* offs, int B, int Nv, int J,
                  unsigned seed, int unit, int sample0, const unsigned* thr,
                  const float* scl) {
  Args<T> a{};
  a.x = static_cast<const T*>(x);
  a.jt = static_cast<const T*>(jt);
  a.w = static_cast<const T*>(w);
  a.offs = static_cast<const int*>(offs);
  a.B = B;
  a.Nv = Nv;
  a.J = J;
  a.nrt = (Nv + TR - 1) / TR;
  a.nqt = (Nv + TQ - 1) / TQ;
  a.seed = seed;
  a.unit = unit;
  a.sample0 = sample0;
  a.attn = Drop{thr[0], scl[0]};
  a.proj = Drop{thr[1], scl[1]};
  a.path = Drop{thr[2], scl[2]};
  a.mlp = Drop{thr[3], scl[3]};
  a.self_ = Drop{thr[4], scl[4]};
  a.outd = Drop{thr[5], scl[5]};
  return a;
}

// launch a kernel of NT threads that takes `smem` bytes of dynamic shared
// memory
template <typename K, typename... A>
int launch_smem(K kern, dim3 grid, int smem, cudaStream_t s, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NT, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// CTAs of lbf_rows_bwd (and lbf_rows_fwd, launched on the same grid) the
// device holds at once
template <typename T>
int rows_wave() {
  auto kern = lbf_rows_bwd_kernel<T>;
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Rows<T>::BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, kern, NT, Rows<T>::BYTES) != cudaSuccess)
    return 0;
  return per * sms;
}

// the pointers of one call, in the order of the C interface below
struct Ptrs {
  void *out, *y3, *q2, *k2, *v2, *a2, *lse, *masks;
  const void* gout;
  void *dx, *djt, *da2, *dd, *dq2, *dk2, *dv2, *djk, *djv, *ops, *part,
      *grads;
};

// K4's rest, by number: 0 lbf_sa_fwd, 1 lbf_sa_bwd_dq, 2 lbf_sa_bwd_dkv,
// 3 lbf_joints_bwd; the dynamic shared memory each takes at Nv vertices
// (the self-attention launches' keys or queries per staged chunk: kc)
template <typename T>
int rest_smem(int kernel, int nv) {
  const int kc = attn::chunk_keys<T, C>(nv);
  if (kernel == 0) return kc * attn::Pad<T, C>::KEY_BYTES;
  if (kernel == 1) return DqSmem<T>::bytes(kc);
  if (kernel == 2) return dkv_chunk<T>(nv) * Dkv<T>::QUERY_BYTES;
  return JointsSmem<T>::BYTES;
}

// what: 0 registers a thread, 1 CTAs resident per SM, 2 shared-memory
// bytes, of rest kernel `kernel` at Nv vertices
template <typename K>
int kernel_info(K kern, int smem, int what) {
  if (what == 2) return smem;
  cudaFuncAttributes attr;
  int per = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kern) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, NT, smem) !=
          cudaSuccess)
    return -1;
  return what == 0 ? attr.numRegs : per;
}

template <typename T>
int info(int kernel, int nv, int what) {
  const int smem = rest_smem<T>(kernel, nv);
  if (kernel == 0) return kernel_info(lbf_sa_fwd_kernel<T>, smem, what);
  if (kernel == 1) return kernel_info(lbf_sa_bwd_dq_kernel<T>, smem, what);
  if (kernel == 2) return kernel_info(lbf_sa_bwd_dkv_kernel<T>, smem, what);
  return kernel_info(lbf_joints_bwd_kernel<T>, smem, what);
}

template <typename T>
int run_fwd(Args<T> a, const Ptrs& q, int nctas, cudaStream_t s) {
  a.out = static_cast<T*>(q.out);
  a.y3 = static_cast<float*>(q.y3);
  a.q2 = static_cast<T*>(q.q2);
  a.k2 = static_cast<T*>(q.k2);
  a.v2 = static_cast<T*>(q.v2);
  a.a2 = static_cast<float*>(q.a2);
  a.lse = static_cast<float*>(q.lse);
  a.masks = static_cast<float*>(q.masks);
  int err = launch_smem(lbf_rows_fwd_kernel<T>, nctas, Rows<T>::BYTES, s, a);
  if (err != 0) return err;
  return launch_smem(lbf_sa_fwd_kernel<T>, dim3(a.nqt, a.B),
                     rest_smem<T>(0, a.Nv), s, a,
                     attn::chunk_keys<T, C>(a.Nv));
}

// floats of the backward's partial buffer: lbf_wgrad's, lbf_rows_bwd's and
// lbf_joints_bwd's rows, then L3's bias shares per query tile
inline long long part_floats(int B, int Nv, int nc_rows, int nc_j,
                             int nc_w) {
  return (long long)nc_w * NW + (long long)nc_rows * NR +
         (long long)nc_j * NJP + (long long)B * ((Nv + TQ - 1) / TQ) * C;
}

template <typename T>
int run_bwd(Args<T> a, const Ptrs& q, int nc_rows, int nc_j, int nc_w,
            int wper, const int* host_offs, cudaStream_t s) {
  a.q2 = static_cast<T*>(q.q2);
  a.k2 = static_cast<T*>(q.k2);
  a.v2 = static_cast<T*>(q.v2);
  a.a2 = static_cast<float*>(q.a2);
  a.lse = static_cast<float*>(q.lse);
  a.gout = static_cast<const T*>(q.gout);
  a.dx = static_cast<T*>(q.dx);
  a.djt = static_cast<T*>(q.djt);
  a.da2 = static_cast<T*>(q.da2);
  a.dd = static_cast<float*>(q.dd);
  a.dq2 = static_cast<float*>(q.dq2);
  a.dk2 = static_cast<float*>(q.dk2);
  a.dv2 = static_cast<float*>(q.dv2);
  a.djk = static_cast<float*>(q.djk);
  a.djv = static_cast<float*>(q.djv);
  a.ops = static_cast<T*>(q.ops);
  a.pw = static_cast<float*>(q.part);
  a.pr = a.pw + (size_t)nc_w * NW;
  a.pj = a.pr + (size_t)nc_rows * NR;
  a.l3b = a.pj + (size_t)nc_j * NJP;
  int err;
  const dim3 sa_grid(a.nqt, a.B);
  if ((err = launch_smem(lbf_sa_bwd_dq_kernel<T>, sa_grid,
                         rest_smem<T>(1, a.Nv), s, a,
                         attn::chunk_keys<T, C>(a.Nv))) != 0)
    return err;
  if ((err = launch_smem(lbf_sa_bwd_dkv_kernel<T>, sa_grid,
                         rest_smem<T>(2, a.Nv), s, a,
                         dkv_chunk<T>(a.Nv))) != 0)
    return err;
  if ((err = launch_smem(lbf_rows_bwd_kernel<T>, nc_rows, Rows<T>::BYTES, s,
                         a)) != 0)
    return err;
  if ((err = launch_smem(lbf_joints_bwd_kernel<T>, nc_j,
                         rest_smem<T>(3, a.Nv), s, a)) != 0)
    return err;
  constexpr int LD = C + 16 / (int)sizeof(T);
  if ((err = launch_smem(lbf_wgrad_kernel<T>, dim3(NWJOB, nc_w),
                         4 * WR * LD * (int)sizeof(T), s, a.ops, a.pw,
                         a.B * a.Nv, wper)) != 0)
    return err;
  return reduce_fields(a.pw, nc_w, a.pr, nc_rows, a.pj, nc_j, host_offs,
                       static_cast<float*>(q.grads), s);
}

}  // namespace ltrain
}  // namespace gator

using gator::ltrain::Ptrs;

// Columns of one row of the backward's weight-gradient operands (`ops`).
extern "C" int lbf_train_op_cols() { return gator::ltrain::O_W; }

// Floats of the backward's f32 partial buffer (`part`) for a call at B
// samples of Nv vertices on these grids.
extern "C" int lbf_train_part_floats(int B, int Nv, int nc_rows, int nc_j,
                                     int nc_w) {
  return (int)gator::ltrain::part_floats(B, Nv, nc_rows, nc_j, nc_w);
}

// Registers a thread (what = 0), CTAs resident per SM (1) or shared-memory
// bytes (2) of lbf_sa_fwd (kernel = 0), lbf_sa_bwd_dq (1), lbf_sa_bwd_dkv
// (2) or lbf_joints_bwd (3) at Nv vertices for dtype (0 = float32, 1 =
// bfloat16); -1 if the query fails.
extern "C" int lbf_train_info(int dtype, int kernel, int Nv, int what) {
  if (dtype == 0) return gator::ltrain::info<float>(kernel, Nv, what);
  return gator::ltrain::info<__nv_bfloat16>(kernel, Nv, what);
}

// CTAs of the rows kernels resident at once on the current device for
// dtype (0 = float32, 1 = bfloat16); 0 if the query fails. The wrapper
// launches at most this many.
extern "C" int lbf_train_rows_wave(int dtype) {
  if (dtype == 0) return gator::ltrain::rows_wave<float>();
  return gator::ltrain::rows_wave<__nv_bfloat16>();
}

// Forward: lbf_rows_fwd (nctas CTAs) then lbf_sa_fwd. dtype: 0 = float32,
// 1 = bfloat16; x, jt, out, q2, k2, v2 in that dtype; y3, a2 f32 [B, Nv,
// 64]; lse f32 [B, 2, Nv] (base 2). thr/scale pairs in the order (attn,
// proj, path, mlp, self, out). masks (may be null): the export buffer, attn
// [B,H,Nv,J] | proj [B,Nv,C] | dp1 [B] | mlp1 [B,Nv,4C] | mlp2 [B,Nv,C] |
// dp2 [B] | self [B,H,Nv,Nv] | out [B,Nv,C].
extern "C" int lbf_train_fwd(int dtype, const void* x, const void* jt,
                             const void* w, const void* offs, void* out,
                             void* y3, void* q2, void* k2, void* v2, void* a2,
                             void* lse, void* masks, int B, int Nv, int J,
                             int nctas, unsigned seed, int unit, int sample0,
                             unsigned t0, float s0, unsigned t1, float s1,
                             unsigned t2, float s2, unsigned t3, float s3,
                             unsigned t4, float s4, unsigned t5, float s5,
                             void* stream) {
  const unsigned thr[6] = {t0, t1, t2, t3, t4, t5};
  const float scl[6] = {s0, s1, s2, s3, s4, s5};
  Ptrs q{};
  q.out = out;
  q.y3 = y3;
  q.q2 = q2;
  q.k2 = k2;
  q.v2 = v2;
  q.a2 = a2;
  q.lse = lse;
  q.masks = masks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::ltrain::run_fwd(
        gator::ltrain::make_args<float>(x, jt, w, offs, B, Nv, J, seed, unit,
                                        sample0, thr, scl),
        q, nctas, s);
  return gator::ltrain::run_fwd(
      gator::ltrain::make_args<__nv_bfloat16>(x, jt, w, offs, B, Nv, J, seed,
                                              unit, sample0, thr, scl),
      q, nctas, s);
}

// Backward: lbf_sa_bwd_dq, lbf_sa_bwd_dkv, lbf_rows_bwd (nc_rows CTAs),
// lbf_joints_bwd (nc_j), lbf_wgrad (nc_w chunks of wper rows), then
// lbf_reduce into grads ([the packed fields' stride] f32; every field's
// elements written, the padding between fields not). q2, k2, v2, da2 and
// ops ([B * Nv, op_cols]) in the input's dtype; a2, lse, dd, dq2, dk2, dv2,
// djk, djv f32; part: lbf_train_part_floats f32, written before it is
// read. host_offs: the fields' offsets (int[23], host memory).
extern "C" int lbf_train_bwd(
    int dtype, const void* x, const void* jt, const void* w, const void* offs,
    const void* gout, void* q2, void* k2, void* v2, void* a2, void* lse,
    void* dx, void* djt, void* da2, void* dd, void* dq2, void* dk2, void* dv2,
    void* djk, void* djv, void* ops, void* part, void* grads,
    const void* host_offs, int B, int Nv, int J, int nc_rows, int nc_j,
    int nc_w, int wper, unsigned seed, int unit, int sample0, unsigned t0,
    float s0,
    unsigned t1, float s1, unsigned t2, float s2, unsigned t3, float s3,
    unsigned t4, float s4, unsigned t5, float s5, void* stream) {
  const unsigned thr[6] = {t0, t1, t2, t3, t4, t5};
  const float scl[6] = {s0, s1, s2, s3, s4, s5};
  Ptrs q{};
  q.q2 = q2;
  q.k2 = k2;
  q.v2 = v2;
  q.a2 = a2;
  q.lse = lse;
  q.gout = gout;
  q.dx = dx;
  q.djt = djt;
  q.da2 = da2;
  q.dd = dd;
  q.dq2 = dq2;
  q.dk2 = dk2;
  q.dv2 = dv2;
  q.djk = djk;
  q.djv = djv;
  q.ops = ops;
  q.part = part;
  q.grads = grads;
  const int* ho = static_cast<const int*>(host_offs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::ltrain::run_bwd(
        gator::ltrain::make_args<float>(x, jt, w, offs, B, Nv, J, seed, unit,
                                        sample0, thr, scl),
        q, nc_rows, nc_j, nc_w, wper, ho, s);
  return gator::ltrain::run_bwd(
      gator::ltrain::make_args<__nv_bfloat16>(x, jt, w, offs, B, Nv, J, seed,
                                              unit, sample0, thr, scl),
      q, nc_rows, nc_j, nc_w, wper, ho, s);
}
