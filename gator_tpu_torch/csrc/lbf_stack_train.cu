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
//                            std-LN, q2/k2/v2 (saved, f32);
//             lbf_sa_fwd     per 64-query tile: online softmax over
//                            64-key tiles with the dropped probabilities;
//                            saves the attention output a2 and the
//                            per-row log-sum-exp, then L3 and the residual;
//   backward  lbf_out_bwd    da2 = (g * m_out) @ L3^T, L3's gradients and
//                            D_i = <da2_i, a2_i> (a2 after dropout);
//             lbf_sa_bwd_dq  per query tile: probabilities recomputed tile
//                            by tile from q2, k2 and the LSE, the mask
//                            regenerated from the hash; dq2;
//             lbf_sa_bwd_dkv per key tile: dk2, dv2;
//             lbf_rows_bwd   per TR-row tile: recomputes the row-local
//                            forward, backpropagates to dx, leaves its
//                            tile's share of the joints' dk/dv, the bias
//                            and norm gradients, and, per row, the two
//                            operands of every weight gradient (`ops`);
//             lbf_joints_bwd per sample: sums those shares, LN1 backward
//                            of the joint rows -> djoints;
//             lbf_wgrad      the row-local weight gradients, X^T dY over
//                            all B * Nv rows of `ops` in fixed chunks;
//             reduce         sums the per-CTA parameter-gradient rows.
// No launch holds a probability matrix; dS = P * (M * dP - D) per tile.
// Parameter gradients go to per-CTA partial rows (fixed grids, fixed
// chunks) summed in a fixed order: repeat runs are bit-identical.
//
// The row-local launches run every product on the tensor cores
// (csrc/mma.cuh): bf16 m16n8k16 on the operands the kernel rounds to bf16
// anyway, or in f32 the 3xTF32 split. A tile's activations live in shared
// memory, in T where they only ever meet a product rounded (layer-norm
// outputs, q, a1, h1, the probabilities times the masks, da1, dq) and in
// f32 where the layer keeps f32 (residuals, scores, backward cotangents);
// each product's weights are staged into shared memory with cp.async, one
// [64, 64] block at a time. At TR = 16 rows a CTA takes 72.6 KB in bf16,
// so three fit on an SM (TR = 32 and two-per-SM versions measured slower
// on the H100). A CTA walks a contiguous run of tiles, so the joints' LN1,
// K and V are computed once per sample it meets, not once per tile. The
// weight gradients are not accumulated per tile: lbf_rows_bwd writes each
// row's operands (`ops`, 2.3 KB a row in bf16) and lbf_wgrad sums them.
//
// What bounds it on the H100: a stage-2 step's row launches need ~37 GFMA
// forward and ~100 backward (0.07 and 0.2 ms on bf16 tensor cores) and
// move ~0.76 GB each way (0.23 ms); they take about 10x and 30x that,
// in the element-wise work between the products (dropout hashes,
// exponentials, GELU, LayerNorms), the block's syncs and the staging.
// The flash self-attention launches still run f32 FMA loops.
#include "mma.cuh"
#include "train_ops.cuh"

namespace gator {
namespace ltrain {

constexpr int C = 64;     // token width
constexpr int H = 2;      // heads
constexpr int D = 32;     // head width
constexpr int HID = 256;  // MLP hidden
constexpr int JMAX = 32;  // most joint tokens
constexpr int HJ = H * JMAX;
constexpr int TR = 16;    // vertex rows per rows-kernel tile
constexpr int TO = 32;    // vertex rows per lbf_out_bwd tile
constexpr int NT = 256;   // threads of the rows kernels
constexpr int TQ = 64;    // query (or key) rows per self-attention CTA
constexpr int TK = 64;    // rows per staged tile
constexpr int NT_SA = TQ * H;

// Field order of a layer's packed weights (and of its gradients); must
// match LAYER_PARAM_KEYS in gator_tpu_torch/nn/lbf_stack_train.py.
enum Field {
  N1_W, N1_B, WQ, WK, WV, PROJ_W, PROJ_B, N2_W, N2_B,
  FC1_W, FC1_B, FC2_W, FC2_B, A2W, B2W,
  L0_W, L0_B, L1_W, L1_B, L2_W, L2_B, L3_W, L3_B, NFIELD
};

// Columns of one row of `ops` (T [B * Nv, O_W]): the forward activations
// and backward cotangents that meet in a row-local weight gradient.
enum OpCol {
  O_YV = 0, O_A1 = 64, O_Y2 = 128, O_Y3 = 192, O_H1D = 256,
  O_DQ2 = 512, O_DK2 = 576, O_DV2 = 640, O_DQ = 704, O_DO = 768,
  O_DH2 = 832, O_DH1 = 896, O_W = 1152
};

// Global scratch of lbf_out_bwd ([TO, C] at 0) and lbf_joints_bwd (joint
// buffers of [JMAX, C]), per CTA.
enum JBuf { J_JT, J_YJ, J_DK, J_DV, J_DYJ, J_STATS, NJBUF };

__host__ __device__ constexpr int jw(int b) { return b == J_STATS ? 4 : C; }

__host__ __device__ constexpr int joff(int b) {
  return b == 0 ? TO * C : joff(b - 1) + jw(b - 1) * JMAX;
}

constexpr long long SCRATCH_FLOATS = joff(NJBUF);

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
  float* q2;         // [B, Nv, C] saved by the forward
  float* k2;
  float* v2;
  float* a2;         // [B, Nv, C] self-attention output after dropout
  float* lse;        // [B, H, Nv] its log-sum-exp
  float* da2;        // [B, Nv, C]
  float* dd;         // [B, H, Nv] D_i
  float* dq2;        // [B, Nv, C]
  float* dk2;
  float* dv2;
  float* djk;        // [B, nrt, J, C] per-tile shares of the joints' dk
  float* djv;        // and dv
  float* scratch;    // per-CTA scratch (SCRATCH_FLOATS each)
  float* part;       // per-CTA gradient partial rows (pstride each)
  long long pstride;
  float* masks;      // mask export (forward; may be null)
  int B, Nv, J;
  int ntiles;        // TO-row tiles of lbf_out_bwd per sample
  int nrt;           // row tiles of the rows kernels per sample
  uint32_t seed;
  int unit;
  Drop attn, proj, path, mlp, self_, outd;
};

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

__device__ __forceinline__ float* sj(float* S, int b) { return S + joff(b); }

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
    const uint32_t key = stream_key(a.seed, a.unit, b, M_ATTN0 + h);
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
  const float dp1 = drop(stream_key(a.seed, a.unit, b, M_DP1), 0, a.path);
  if (dump && tile == 0 && tid == 0) a.masks[ex.dp1 + b] = dp1;
  const uint32_t kproj = stream_key(a.seed, a.unit, b, M_PROJ);
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
  const uint32_t kmlp1 = stream_key(a.seed, a.unit, b, M_MLP1);
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
  const float dp2 = drop(stream_key(a.seed, a.unit, b, M_DP2), 0, a.path);
  if (dump && tile == 0 && tid == 0) a.masks[ex.dp2 + b] = dp2;
  const uint32_t kmlp2 = stream_key(a.seed, a.unit, b, M_MLP2);
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
  float* const outs[3] = {a.q2, a.k2, a.v2};
  for (int i = 0; i < 3; ++i) {
    __syncthreads();
    load_w(WS, p + o[L0_W + 2 * i], C, 0, 0);
    ready();
    const T* bias = p + o[L0_B + 2 * i];
    float* dst = outs[i] + row0 * C;
    tc::gemm<T, NB>(MT, C / 8, C, RowMajor<T>{Y3, L::LT},
                    RowMajor<T>{WS, L::LT}, [&](int r, int c, float v) {
                      if (r < nr) dst[r * C + c] = v + ld(bias + c);
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

// Self-attention forward, one thread per (head, query row) of a 64-row
// tile: online softmax of the raw scores, the kept probabilities times v.
template <typename T>
__global__ void __launch_bounds__(NT_SA) lbf_sa_fwd_kernel(Args<T> a) {
  __shared__ __align__(16) float Ks[TK * C];  // key tile; then a2 [TQ, C]
  __shared__ __align__(16) float Vs[TK * C];
  const int Nv = a.Nv;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int h = tid / TQ;
  const int r = tid % TQ;
  const int row = min(r0 + r, Nv - 1);
  const bool valid = r0 + r < Nv;
  const float scale = rsqrtf((float)D);
  const size_t base = (size_t)b * Nv;
  const bool dump = a.masks != nullptr && valid;
  const Export<T> ex(a);
  const uint32_t key = stream_key(a.seed, a.unit, b, M_SELF0 + h);

  float q[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = rnd<T>(a.q2[(base + row) * C + h * D + d]);
    acc[d] = 0.0f;
  }
  float mx = -CUDART_INF_F;
  float l = 0.0f;
  for (int k0 = 0; k0 < Nv; k0 += TK) {
    const int nk = min(TK, Nv - k0);
    __syncthreads();
    for (int i = tid; i < nk * C; i += NT_SA) {
      Ks[i] = rnd<T>(a.k2[(base + k0) * C + i]);
      Vs[i] = rnd<T>(a.v2[(base + k0) * C + i]);
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float* kr = Ks + j * C + h * D;
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q[d], kr[d], s);
      s *= scale;
      if (s > mx) {
        const float corr = expf(mx - s);
        l *= corr;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= corr;
        mx = s;
      }
      const float e = expf(s - mx);
      l += e;
      const float mk = drop(key, row * Nv + k0 + j, a.self_);
      if (dump)
        a.masks[ex.self_ + ((base * H + (size_t)h * Nv) + row) * Nv + k0 + j] =
            mk;
      const float em = e * mk;
      const float* vr = Vs + j * C + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(em, vr[d], acc[d]);
    }
  }
  __syncthreads();
  float* O = Ks;
  const float inv = 1.0f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float v = acc[d] * inv;
    O[r * C + h * D + d] = v;
    if (valid) a.a2[(base + row) * C + h * D + d] = v;
  }
  if (valid) a.lse[(b * H + h) * (size_t)Nv + row] = mx + logf(l);
  __syncthreads();

  // out = y3 + OutDrop(a2 @ L3 + b)
  const int nq = min(TQ, Nv - r0);
  const T* l3_b = a.w + a.offs[L3_B];
  const uint32_t kout = stream_key(a.seed, a.unit, b, M_OUT);
  gemm_nn<T>(O, C, nq, C, a.w + a.offs[L3_W], C, C,
             [&](int rr, int c, float v) {
               const int n = r0 + rr;
               const size_t i = (base + n) * C + c;
               const float mk = drop(kout, n * C + c, a.outd);
               if (a.masks) a.masks[ex.out + i] = mk;
               a.out[i] = Num<T>::from_float(a.y3[i] + (v + ld(l3_b + c)) * mk);
             });
}

// da2 = (g * m_out) @ L3^T, L3's gradients, D_i = <rnd(da2_i), a2_i> per
// head; one TO-row tile per step of a grid-stride loop.
template <typename T>
__global__ void __launch_bounds__(NT) lbf_out_bwd_kernel(Args<T> a) {
  float* S = a.scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  float* PG = a.part + (size_t)blockIdx.x * a.pstride;
  float* DSA = S;
  const int Nv = a.Nv;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  for (int t = blockIdx.x; t < a.B * a.ntiles; t += gridDim.x) {
    const int b = t / a.ntiles;
    const int r0 = t % a.ntiles * TO;
    const int nr = min(TO, Nv - r0);
    const size_t row0 = (size_t)b * Nv + r0;
    const uint32_t kout = stream_key(a.seed, a.unit, b, M_OUT);
    for (int i = tid; i < nr * C; i += NT)
      DSA[i] = Num<T>::to_float(a.gout[row0 * C + i]) *
               drop(kout, (r0 + i / C) * C + i % C, a.outd);
    __syncthreads();
    gemm_nt<T, 2>(DSA, C, nr, C, p + o[L3_W], C, C, [&](int r, int k,
                                                        float v) {
      a.da2[(row0 + r) * C + k] = v;
    });
    gemm_tn_acc<T, 4>(a.a2 + row0 * C, C, DSA, C, nr, C, C, PG + o[L3_W], C);
    colsum_acc(DSA, C, nr, C, PG + o[L3_B]);
    __syncthreads();
    for (int task = tid; task < H * nr; task += NT) {
      const int h = task / nr;
      const int r = task % nr;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) {
        const size_t i = (row0 + r) * C + h * D + d;
        s = fmaf(rnd<T>(a.da2[i]), a.a2[i], s);
      }
      a.dd[(b * H + h) * (size_t)Nv + r0 + r] = s;
    }
    __syncthreads();
  }
}

// dq2 per (head, query row): probabilities recomputed from the LSE.
template <typename T>
__global__ void __launch_bounds__(NT_SA) lbf_sa_bwd_dq_kernel(Args<T> a) {
  __shared__ __align__(16) float Ks[TK * C];
  __shared__ __align__(16) float Vs[TK * C];
  const int Nv = a.Nv;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int h = tid / TQ;
  const int r = tid % TQ;
  const int row = min(r0 + r, Nv - 1);
  const float scale = rsqrtf((float)D);
  const size_t base = (size_t)b * Nv;
  const uint32_t key = stream_key(a.seed, a.unit, b, M_SELF0 + h);
  float q[D], da[D], dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = rnd<T>(a.q2[(base + row) * C + h * D + d]);
    da[d] = rnd<T>(a.da2[(base + row) * C + h * D + d]);
    dq[d] = 0.0f;
  }
  const float lse = a.lse[(b * H + h) * (size_t)Nv + row];
  const float Di = a.dd[(b * H + h) * (size_t)Nv + row];
  for (int k0 = 0; k0 < Nv; k0 += TK) {
    const int nk = min(TK, Nv - k0);
    __syncthreads();
    for (int i = tid; i < nk * C; i += NT_SA) {
      Ks[i] = rnd<T>(a.k2[(base + k0) * C + i]);
      Vs[i] = rnd<T>(a.v2[(base + k0) * C + i]);
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float* kr = Ks + j * C + h * D;
      const float* vr = Vs + j * C + h * D;
      float s = 0.0f, dpd = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q[d], kr[d], s);
        dpd = fmaf(da[d], vr[d], dpd);
      }
      const float pr = expf(s * scale - lse);
      const float mk = drop(key, row * Nv + k0 + j, a.self_);
      const float ds = rnd<T>(pr * (mk * dpd - Di) * scale);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, kr[d], dq[d]);
    }
  }
  if (r0 + r < Nv) {
#pragma unroll
    for (int d = 0; d < D; ++d) a.dq2[(base + row) * C + h * D + d] = dq[d];
  }
}

// dk2, dv2 per (head, key row): the query tiles staged in shared memory.
template <typename T>
__global__ void __launch_bounds__(NT_SA) lbf_sa_bwd_dkv_kernel(Args<T> a) {
  __shared__ __align__(16) float Qs[TQ * C];
  __shared__ __align__(16) float DAs[TQ * C];
  __shared__ float LSEs[H * TQ];
  __shared__ float DDs[H * TQ];
  const int Nv = a.Nv;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * TK;
  const int tid = threadIdx.x;
  const int h = tid / TK;
  const int r = tid % TK;
  const int col = min(c0 + r, Nv - 1);
  const float scale = rsqrtf((float)D);
  const size_t base = (size_t)b * Nv;
  const uint32_t key = stream_key(a.seed, a.unit, b, M_SELF0 + h);
  float k[D], v[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    k[d] = rnd<T>(a.k2[(base + col) * C + h * D + d]);
    v[d] = rnd<T>(a.v2[(base + col) * C + h * D + d]);
    dk[d] = dv[d] = 0.0f;
  }
  for (int i0 = 0; i0 < Nv; i0 += TQ) {
    const int ni = min(TQ, Nv - i0);
    __syncthreads();
    for (int i = tid; i < ni * C; i += NT_SA) {
      Qs[i] = rnd<T>(a.q2[(base + i0) * C + i]);
      DAs[i] = rnd<T>(a.da2[(base + i0) * C + i]);
    }
    for (int i = tid; i < H * ni; i += NT_SA) {
      const int hh = i / ni;
      const int ii = i % ni;
      LSEs[hh * TQ + ii] = a.lse[(b * H + hh) * (size_t)Nv + i0 + ii];
      DDs[hh * TQ + ii] = a.dd[(b * H + hh) * (size_t)Nv + i0 + ii];
    }
    __syncthreads();
    for (int i = 0; i < ni; ++i) {
      const float* qr = Qs + i * C + h * D;
      const float* dr = DAs + i * C + h * D;
      float s = 0.0f, dpd = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], k[d], s);
        dpd = fmaf(dr[d], v[d], dpd);
      }
      const float pr = expf(s * scale - LSEs[h * TQ + i]);
      const float mk = drop(key, (i0 + i) * Nv + col, a.self_);
      const float ds = rnd<T>(pr * (mk * dpd - DDs[h * TQ + i]) * scale);
      const float pd = rnd<T>(pr * mk);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk[d] = fmaf(ds, qr[d], dk[d]);
        dv[d] = fmaf(pd, dr[d], dv[d]);
      }
    }
  }
  if (c0 + r < Nv) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      a.dk2[(base + col) * C + h * D + d] = dk[d];
      a.dv2[(base + col) * C + h * D + d] = dv[d];
    }
  }
}


// The row-local backward of one (sample, tile), after rows_fwd: dx, this
// tile's shares of the joints' dk/dv, the bias and norm gradients into the
// CTA's partial row PG, and the cotangent operands of the weight
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
  colsum_acc(a.dq2 + row0 * C, C, nr, C, PG + o[L0_B]);
  colsum_acc(a.dk2 + row0 * C, C, nr, C, PG + o[L1_B]);
  colsum_acc(a.dv2 + row0 * C, C, nr, C, PG + o[L2_B]);
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
  norm_param_acc(S0, L::LF, X2, L::LF, STATS, nr, C, PG + o[A2W],
                 PG + o[B2W]);
  load_w(WS, p + o[FC1_W], HID, 0, 0);
  // x2 = x1 + dp2 * m2 * h2
  const float dp2 = drop(stream_key(a.seed, a.unit, b, M_DP2), 0, a.path);
  const uint32_t kmlp2 = stream_key(a.seed, a.unit, b, M_MLP2);
  for (int i = tid; i < TR * C; i += NT) {
    const int r = i / C, c = i % C;
    const float v = DX[r * L::LF + c] * dp2 *
                    drop(kmlp2, (r0 + r) * C + c, a.mlp);
    S2[r * L::LF + c] = v;
    put(O_DH2, r, c, v);
  }
  ready();
  colsum_acc(S2, L::LF, nr, C, PG + o[FC2_B]);
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
  const uint32_t kmlp1 = stream_key(a.seed, a.unit, b, M_MLP1);
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
  colsum_acc(RR, L::LFH, nr, HID, PG + o[FC1_B]);
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
  norm_param_acc(S0, L::LF, X1, L::LF, STATS, nr, C, PG + o[N2_W],
                 PG + o[N2_B]);
  load_w(WS, p + o[PROJ_W], C, 0, 0);
  // x1 = x + dp1 * mproj * (a1 @ proj + b)
  const float dp1 = drop(stream_key(a.seed, a.unit, b, M_DP1), 0, a.path);
  const uint32_t kproj = stream_key(a.seed, a.unit, b, M_PROJ);
  for (int i = tid; i < TR * C; i += NT) {
    const int r = i / C, c = i % C;
    const float v = DX[r * L::LF + c] * dp1 *
                    drop(kproj, (r0 + r) * C + c, a.proj);
    S2[r * L::LF + c] = v;
    put(O_DO, r, c, v);
  }
  ready();
  colsum_acc(S2, L::LF, nr, C, PG + o[PROJ_B]);
  tc::gemm<T, NB>(MT, C / 8, C, RowMajor<float>{S2, L::LF},
                  ColMajor<T>{WS, L::LT}, [&](int r, int k, float v) {
                    DA1[r * L::LT + k] = N::from_float(v);
                  });
  __syncthreads();
  load_w(WS, p + o[WQ], C, 0, 0);
  // cross-attention backward: dprob = m * (da . v) per (row, head, key),
  // then ds = p * (dprob - <dprob, p>) * scale per (row, head)
  for (int h = 0; h < H; ++h) {
    const uint32_t key = stream_key(a.seed, a.unit, b, M_ATTN0 + h);
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
  norm_param_acc(S2, L::LF, X, L::LF, STATS, nr, C, PG + o[N1_W],
                 PG + o[N1_B]);
}

template <typename T>
__global__ void __launch_bounds__(NT, Rows<T>::MIN_CTAS)
    lbf_rows_bwd_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char sm[];
  float* PG = a.part + (size_t)blockIdx.x * a.pstride;
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
// a 64 x 64 tile of field `field`, at element g0 of it, rows ldg apart
struct WJob {
  int ca, cb, field, g0, ldg;
};

constexpr int NWJOB = 13;

__device__ __forceinline__ WJob wjob(int j) {
  if (j < 3) return {O_Y3, O_DQ2 + C * j, L0_W + 2 * j, 0, C};
  if (j < 7) return {O_H1D + C * (j - 3), O_DH2, FC2_W, C * C * (j - 3), C};
  if (j < 11) return {O_Y2, O_DH1 + C * (j - 7), FC1_W, C * (j - 7), HID};
  if (j == 11) return {O_A1, O_DO, PROJ_W, 0, C};
  return {O_YV, O_DQ, WQ, 0, C};
}

constexpr int WR = 64;  // rows of ops per staged chunk

// One CTA per (64 x 64 tile, chunk of `per` rows): the chunk's rows staged
// through shared memory in a two-deep cp.async ring, each 64 rows' sum on
// the tensor cores and the running sum in f32 registers (rounded to
// nearest: the tensor cores' accumulation does not round so, and a chunk
// of thousands of rows would drift), in a fixed order; the tile written
// to the chunk's partial row of `part`.
template <typename T>
__global__ void __launch_bounds__(NT) lbf_wgrad_kernel(
    const T* __restrict__ ops, const int* __restrict__ offs, float* part,
    long long pstride, int R, int per) {
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
  float* G = part + (size_t)blockIdx.y * pstride + offs[job.field] + job.g0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    G[(m0 + g) * job.ldg + n] = tot[j][0];
    G[(m0 + g) * job.ldg + n + 1] = tot[j][1];
    G[(m0 + g + 8) * job.ldg + n] = tot[j][2];
    G[(m0 + g + 8) * job.ldg + n + 1] = tot[j][3];
  }
}

// Per sample: the joints' dk, dv summed over the tiles (in order), wk/wv
// gradients, and the LN1 backward of the joint rows -> djoints.
template <typename T>
__global__ void __launch_bounds__(NT) lbf_joints_bwd_kernel(Args<T> a) {
  float* S = a.scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  float* PG = a.part + (size_t)blockIdx.x * a.pstride;
  float* JT = sj(S, J_JT);
  float* YJ = sj(S, J_YJ);
  float* DK = sj(S, J_DK);
  float* DV = sj(S, J_DV);
  float* DYJ = sj(S, J_DYJ);
  float* STATS = sj(S, J_STATS);
  const int J = a.J;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    for (int i = tid; i < J * C; i += NT) {
      JT[i] = Num<T>::to_float(a.jt[(size_t)b * J * C + i]);
      float sk = 0.0f, sv = 0.0f;
      for (int t = 0; t < a.nrt; ++t) {
        const size_t at = (((size_t)b * a.nrt + t) * J) * C + i;
        sk += a.djk[at];
        sv += a.djv[at];
      }
      DK[i] = sk;
      DV[i] = sv;
    }
    __syncthreads();
    layer_norm_rows<C>(JT, C, J, p + o[N1_W], p + o[N1_B], 1e-5f, false,
                       [&](int r, int c, float v) { YJ[r * C + c] = v; });
    __syncthreads();
    gemm_tn_acc<T, 4>(YJ, C, DK, C, J, C, C, PG + o[WK], C);
    gemm_tn_acc<T, 4>(YJ, C, DV, C, J, C, C, PG + o[WV], C);
    gemm_nt<T, 2>(DK, C, J, C, p + o[WK], C, C,
                  [&](int r, int k, float v) { DYJ[r * C + k] = v; });
    gemm_nt<T, 2>(DV, C, J, C, p + o[WV], C, C,
                  [&](int r, int k, float v) { DYJ[r * C + k] += v; });
    __syncthreads();
    ln_bwd_rows<C>(DYJ, C, JT, C, J, p + o[N1_W], 1e-5f, STATS,
                   [&](int r, int c, float v) {
                     a.djt[((size_t)b * J + r) * C + c] = Num<T>::from_float(v);
                   });
    __syncthreads();
    norm_param_acc(DYJ, C, JT, C, STATS, J, C, PG + o[N1_W], PG + o[N1_B]);
    __syncthreads();
  }
}

template <typename T>
Args<T> make_args(const void* x, const void* jt, const void* w,
                  const void* offs, int B, int Nv, int J,
                  unsigned seed, int unit, const unsigned* thr,
                  const float* scl) {
  Args<T> a{};
  a.x = static_cast<const T*>(x);
  a.jt = static_cast<const T*>(jt);
  a.w = static_cast<const T*>(w);
  a.offs = static_cast<const int*>(offs);
  a.B = B;
  a.Nv = Nv;
  a.J = J;
  a.ntiles = (Nv + TO - 1) / TO;
  a.nrt = (Nv + TR - 1) / TR;
  a.seed = seed;
  a.unit = unit;
  a.attn = Drop{thr[0], scl[0]};
  a.proj = Drop{thr[1], scl[1]};
  a.path = Drop{thr[2], scl[2]};
  a.mlp = Drop{thr[3], scl[3]};
  a.self_ = Drop{thr[4], scl[4]};
  a.outd = Drop{thr[5], scl[5]};
  return a;
}

// launch a kernel that takes `smem` bytes of dynamic shared memory
template <typename K, typename... A>
int launch_smem(K kern, int grid, int smem, cudaStream_t s, A... args) {
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
  void *out, *y3, *q2, *k2, *v2, *a2, *lse, *scratch, *masks;
  const void* gout;
  void *dx, *djt, *da2, *dd, *dq2, *dk2, *dv2, *djk, *djv, *ops, *part,
      *grads;
};

template <typename T>
int run_fwd(Args<T> a, const Ptrs& q, int nctas, cudaStream_t s) {
  a.out = static_cast<T*>(q.out);
  a.y3 = static_cast<float*>(q.y3);
  a.q2 = static_cast<float*>(q.q2);
  a.k2 = static_cast<float*>(q.k2);
  a.v2 = static_cast<float*>(q.v2);
  a.a2 = static_cast<float*>(q.a2);
  a.lse = static_cast<float*>(q.lse);
  a.masks = static_cast<float*>(q.masks);
  int err = launch_smem(lbf_rows_fwd_kernel<T>, nctas, Rows<T>::BYTES, s, a);
  if (err != 0) return err;
  dim3 grid((a.Nv + TQ - 1) / TQ, a.B);
  lbf_sa_fwd_kernel<T><<<grid, NT_SA, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run_bwd(Args<T> a, const Ptrs& q, int nc_out, int nc_rows,
            int nc_j, int nc_w, int wper, long long pstride, int ngrad,
            cudaStream_t s) {
  a.q2 = static_cast<float*>(q.q2);
  a.k2 = static_cast<float*>(q.k2);
  a.v2 = static_cast<float*>(q.v2);
  a.a2 = static_cast<float*>(q.a2);
  a.lse = static_cast<float*>(q.lse);
  a.scratch = static_cast<float*>(q.scratch);
  a.gout = static_cast<const T*>(q.gout);
  a.dx = static_cast<T*>(q.dx);
  a.djt = static_cast<T*>(q.djt);
  a.da2 = static_cast<float*>(q.da2);
  a.dd = static_cast<float*>(q.dd);
  a.dq2 = static_cast<float*>(q.dq2);
  a.dk2 = static_cast<float*>(q.dk2);
  a.dv2 = static_cast<float*>(q.dv2);
  a.djk = static_cast<float*>(q.djk);
  a.djv = static_cast<float*>(q.djv);
  a.ops = static_cast<T*>(q.ops);
  a.pstride = pstride;
  float* part = static_cast<float*>(q.part);
  int err;
  a.part = part;
  lbf_out_bwd_kernel<T><<<nc_out, NT, 0, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  dim3 grid((a.Nv + TQ - 1) / TQ, a.B);
  lbf_sa_bwd_dq_kernel<T><<<grid, NT_SA, 0, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  lbf_sa_bwd_dkv_kernel<T><<<grid, NT_SA, 0, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  a.part = part + (size_t)nc_out * pstride;
  if ((err = launch_smem(lbf_rows_bwd_kernel<T>, nc_rows, Rows<T>::BYTES, s,
                         a)) != 0)
    return err;
  a.part = part + (size_t)(nc_out + nc_rows) * pstride;
  lbf_joints_bwd_kernel<T><<<nc_j, NT, 0, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  constexpr int LD = C + 16 / (int)sizeof(T);
  const int wsmem = 4 * WR * LD * (int)sizeof(T);
  auto wk = lbf_wgrad_kernel<T>;
  if ((err = (int)cudaFuncSetAttribute(
           wk, cudaFuncAttributeMaxDynamicSharedMemorySize, wsmem)) != 0)
    return err;
  wk<<<dim3(NWJOB, nc_w), NT, wsmem, s>>>(
      a.ops, a.offs, part + (size_t)(nc_out + nc_rows + nc_j) * pstride,
      pstride, a.B * a.Nv, wper);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return reduce_partials(part, nc_out + nc_rows + nc_j + nc_w, pstride, ngrad,
                         static_cast<float*>(q.grads), s);
}

}  // namespace ltrain
}  // namespace gator

using gator::ltrain::Ptrs;

// Floats of global scratch per CTA of lbf_out_bwd and lbf_joints_bwd.
extern "C" int lbf_train_scratch() {
  return (int)gator::ltrain::SCRATCH_FLOATS;
}

// Columns of one row of the backward's weight-gradient operands (`ops`).
extern "C" int lbf_train_op_cols() { return gator::ltrain::O_W; }

// CTAs of the rows kernels resident at once on the current device for
// dtype (0 = float32, 1 = bfloat16); 0 if the query fails. The wrapper
// launches at most this many.
extern "C" int lbf_train_rows_wave(int dtype) {
  if (dtype == 0) return gator::ltrain::rows_wave<float>();
  return gator::ltrain::rows_wave<__nv_bfloat16>();
}

// Forward: lbf_rows_fwd (nctas CTAs) then
// lbf_sa_fwd. dtype: 0 = float32, 1 = bfloat16; x, jt, out in that dtype;
// y3, q2, k2, v2, a2 f32 [B, Nv, 64]; lse f32 [B, 2, Nv]. thr/scale pairs
// in the order (attn, proj, path, mlp, self, out). masks (may be null): the
// export buffer, attn [B,H,Nv,J] | proj [B,Nv,C] | dp1 [B] | mlp1
// [B,Nv,4C] | mlp2 [B,Nv,C] | dp2 [B] | self [B,H,Nv,Nv] | out [B,Nv,C].
extern "C" int lbf_train_fwd(int dtype, const void* x, const void* jt,
                             const void* w, const void* offs, void* out,
                             void* y3, void* q2, void* k2, void* v2, void* a2,
                             void* lse, void* masks, int B, int Nv, int J,
                             int nctas, unsigned seed, int unit,
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
                                        thr, scl),
        q, nctas, s);
  return gator::ltrain::run_fwd(
      gator::ltrain::make_args<__nv_bfloat16>(x, jt, w, offs, B, Nv, J, seed,
                                              unit, thr, scl),
      q, nctas, s);
}

// Backward: lbf_out_bwd, lbf_sa_bwd_dq, lbf_sa_bwd_dkv, lbf_rows_bwd,
// lbf_joints_bwd, lbf_wgrad (nc_w chunks of wper rows), then the reduction
// of the gradient partials (part: [nc_out + nc_rows + nc_j + nc_w,
// pstride] f32, zeroed by the caller) into grads ([ngrad] f32). da2, dd,
// dq2, dk2, dv2, djk, djv: f32 work buffers; ops: [B * Nv, op_cols] in the
// input's dtype.
extern "C" int lbf_train_bwd(
    int dtype, const void* x, const void* jt, const void* w, const void* offs,
    const void* gout, void* q2, void* k2, void* v2, void* a2, void* lse,
    void* dx, void* djt, void* da2, void* dd, void* dq2, void* dk2, void* dv2,
    void* djk, void* djv, void* ops, void* scratch, void* part,
    long long pstride, void* grads, int ngrad, int B, int Nv, int J,
    int nc_out, int nc_rows, int nc_j, int nc_w, int wper, unsigned seed,
    int unit, unsigned t0, float s0, unsigned t1, float s1, unsigned t2,
    float s2, unsigned t3, float s3, unsigned t4, float s4, unsigned t5,
    float s5, void* stream) {
  const unsigned thr[6] = {t0, t1, t2, t3, t4, t5};
  const float scl[6] = {s0, s1, s2, s3, s4, s5};
  Ptrs q{};
  q.q2 = q2;
  q.k2 = k2;
  q.v2 = v2;
  q.a2 = a2;
  q.lse = lse;
  q.scratch = scratch;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::ltrain::run_bwd(
        gator::ltrain::make_args<float>(x, jt, w, offs, B, Nv, J, seed, unit,
                                        thr, scl),
        q, nc_out, nc_rows, nc_j, nc_w, wper, pstride, ngrad, s);
  return gator::ltrain::run_bwd(
      gator::ltrain::make_args<__nv_bfloat16>(x, jt, w, offs, B, Nv, J, seed,
                                              unit, thr, scl),
      q, nc_out, nc_rows, nc_j, nc_w, wper, pstride, ngrad, s);
}
