// One MDR LBF layer of unfolded weights, as two launches: the device code
// shared by K2-layer (lbf_layer.cu) and T1 (lbf_ablate.cu). K2
// (lbf_stack.cu) runs the row-local launch too, under T1's policy with an
// f32 residual input; its self-attention is its own.
//
// The layer (reference: lib/models/MDR.py:139-153; gator_tpu/nn/
// pallas_mdr.py:87 `_layer_math`):
//   x1 = x + Proj(CrossAttn(LN1(x) -> LN1(joints)))     (J joint keys)
//   x2 = x1 + MLP(LN2(x1))                              (exact GELU, 256)
//   y3 = StdLN(x2)                    (n-1 std, eps 1e-6 added to the std)
//   x' = y3 + L3(SelfAttn(L0 y3, L1 y3, L2 y3))         (Nv x Nv, 2 heads)
//
// Two template parameters set what a kernel computes (a third, TX, is the
// type of the residual input x: T, or f32 for K2):
//   kRoundAll  the rounding policy. true (K2-layer, `_layer_math`): every
//              product and every bias add is rounded to the working type
//              T, and y3 is rounded before the residual. false (T1,
//              tools/exp_mdr_ablate.py `_kernel:49`): products and bias
//              adds stay f32, an operand is rounded where it enters a
//              product, y3 stays f32 for the residual. Both round q, k, v,
//              the normalised probabilities and the head outputs to T.
//   kMode      T1's ablation (`enum Mode`; K2-layer is FULL). It is fixed
//              at compile time, so no inner loop branches on it.
//
// Design. The layer is cut where its rows stop being independent, as in
// K2 (lbf_stack.cu):
//   rows_kernel: per (32-row tile, sample; 16 in f32): the cross-attention
//                over the J joints, LN2, the MLP, the std-LN and the q2/k2/v2
//                projections (T1's preproj and fold1dot project v2 through
//                L3 here). Row-local modes write the layer's output here.
//                K2 runs it too.
//   attn_kernel: per (64-query tile, sample), both heads: the softmax over
//                all Nv keys in two passes over 64-key tiles staged in
//                shared memory: the first takes each row's max and sum
//                online, the second recomputes the scores and adds
//                T(exp(s - max) / sum) * V, so the normalised probability
//                is rounded where the TPU kernels round it and no score
//                tile is stored (1.5x K2's QK work). Then L3 and the
//                residual. K2 has its own, on the tensor cores.
// rows_kernel runs every product on the tensor cores (mma.cuh: bf16
// m16n8k16 on the operands the FMA chain rounded to T anyway, so each
// product is exact and only the f32 sums reorder; f32 as 3xTF32), the
// cross-attention's J-wide scores and P @ V included (J padded to 32; on
// the FMA pipes they took ~4 % of the row work, on the tensor cores they
// cost less than the softmax between them, one warp per (row, head)).
// Activations that only enter a product rounded live in shared memory in
// T, the residual and the scores in f32. The weights pass through two
// [64, 64] slots: cp.async fills one while the products read the other
// (13 blocks a tile in `full`). A persistent grid (the CTAs the device
// holds) walks the B * ceil(Nv / TR) (sample, tile) items in contiguous
// runs, so a sample's joints get their LN1, K and V once per CTA that
// meets it (the FMA design redid them for every tile), and no grid
// dimension limits the batch. 69.5 KB of shared memory a CTA in bf16:
// three fit on an SM.
// attn_kernel is still the FMA design: one thread per (query row, head),
// past the grid's 65535 samples the host launches again. The ragged Nv edge
// is masked by row counts; the TPU kernels' 431->432 padding, their
// block-diagonal cross mask and the A&S erf polynomial are gone (exact
// erff; the two differ by 1.5e-7).
//
// What bounds it on the H100. rows_kernel: ~25 MFMA per sample at Nv=431
// (51 GFMA a layer at B = 2048: 0.10 ms on bf16 tensor cores) against
// ~0.79 GB of x in and y3, q2, k2, v2 out in K2 (f32 x and y3: 0.24 ms);
// below both, the element-wise work between the products (LayerNorms,
// erf, the cross softmax), the block's syncs and the weight staging.
// attn_kernel: ~36 MFMA per sample at Nv=431 on the f32 pipes (its QK
// products done twice).
#pragma once

#include "mma.cuh"

namespace gator {
namespace lbf_layer {

constexpr int C = 64;     // token width
constexpr int H = 2;      // heads
constexpr int D = 32;     // head width
constexpr int HID = 256;  // MLP hidden
constexpr int JMAX = 32;  // most joint tokens
constexpr int NT_ROWS = 256;
constexpr int TQ = 64;    // query rows per attn_kernel CTA
constexpr int TK = 64;    // keys per staged tile
constexpr int NT_ATTN = TQ * H;
constexpr int MAX_GRID_B = 65535;  // samples per launch (the grid's y limit)
// D ** -0.5 and T1's nosoftmax factor D ** -0.5 / 431, each rounded once
// to f32 from the double, as the JAX kernels' Python scalars are
constexpr float kScale = (float)0.17677669529663687;
constexpr float kScaleNoSoftmax = (float)(0.17677669529663687 / 431.0);

// Field order of one layer's packed weights; must match
// gator_tpu_torch/nn/lbf_layer.py STACK_FIELDS.
enum Field {
  LN1_W, LN1_B, WQ, WK, WV, PROJ_W, PROJ_B, LN2_W, LN2_B,
  FC1_W, FC1_B, FC2_W, FC2_B, A2, B2,
  L0_W, L0_B, L1_W, L1_B, L2_W, L2_B, L3_W, L3_B, NFIELD
};

// T1's modes; must match gator_tpu_torch/nn/lbf_ablate.py MODES.
enum Mode {
  FULL, LNONLY, MLPONLY, NOCROSS, NOMLP, NOGELU, TANHGELU, BF16GELU,
  NOSELF, PREPROJ, FOLD1DOT, BF16SMAX, NOSOFTMAX, NMODE
};

// width of a self-attention V row in memory
__host__ __device__ constexpr int v_width(int mode) {
  return mode == FOLD1DOT ? H * C : C;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// a product or bias add under the rounding policy
template <typename T, bool kRoundAll>
__device__ __forceinline__ float rp(float v) {
  return kRoundAll ? rnd<T>(v) : v;
}

// the MLP's activation of fc1's product v plus bias b, before the rounding
// to T where it enters fc2
template <typename T, bool kRoundAll, int kMode>
__device__ __forceinline__ float activation(float v, float b) {
  const float pre = rp<T, kRoundAll>(rp<T, kRoundAll>(v) + b);
  if constexpr (kMode == NOGELU) {
    return pre;
  } else if constexpr (kMode == TANHGELU) {
    return 0.5f * pre *
           (1.0f + tanhf(0.7978845608028654f * (pre + 0.044715f *
                                                          (pre * pre * pre))));
  } else if constexpr (kMode == BF16GELU) {
    return rnd<T>(gelu_exact(rnd<T>(pre)));
  } else {
    return gelu_exact(pre);
  }
}

// Shared memory of rows_kernel, in bytes from the start. Rows of width w
// are padded by 16 bytes (w + 4 f32, w + 16 / sizeof(T) T), so that the
// fragment loads of a warp fall in distinct banks. Activations that only
// ever enter a product rounded are held in T (the mma operands), the
// residual and the scores in f32.
template <typename T>
struct RowsSmem {
  // vertex rows per tile: 32 in bf16, 16 in f32, so that three and two
  // CTAs fit on an SM (69.5 and 84.3 KB; 16 rows in bf16 measured 12 %
  // slower)
  static constexpr int TR = sizeof(T) == 2 ? 32 : 16;
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int LF = C + 4;                 // f32 rows
  static constexpr int LT = C + E, LTH = HID + E;  // T rows
  static constexpr int FB = TR * LF * 4;               // [TR, C] f32
  static constexpr int TB = TR * LT * (int)sizeof(T);  // [TR, C] T
  static constexpr int JB = JMAX * LT * (int)sizeof(T);
  static constexpr int WB = C * LT * (int)sizeof(T);   // a [64, 64] block
  // X: the residual; Y: LN1, then LN2, then the rounded y3; Q: q, then
  // the cross output, then T(v2) (preproj, fold1dot); KJ, VJ: the
  // sample's joint keys and values; WS: the two weight slots
  static constexpr int X = 0, Y = X + FB, Q = Y + TB, KJ = Q + TB,
                       VJ = KJ + JB, WS = VJ + JB, U = WS + 2 * WB;
  // U, in turn: the joints' input and LN1 while a sample's K and V are
  // made; the cross scores [TR, H * JMAX] (lnonly: its f32 norms) and
  // probabilities; the MLP hidden and fc2's partial sums
  static constexpr int JT = U, YJ = JT + JMAX * LF * 4;
  static constexpr int P = U, PM = P + FB;
  static constexpr int H1 = U, ACC = H1 + TR * LTH * (int)sizeof(T);
  static constexpr int BYTES =
      cmax(YJ + JB, cmax(PM + TB, ACC + FB));
  // CTAs an SM should hold (at most 85 registers a thread in bf16)
  static constexpr int MIN_CTAS = sizeof(T) == 2 ? 3 : 2;
  static_assert(TR % 16 == 0 && H * JMAX <= C && JMAX == 32, "tile shapes");
};

// an mma operand read element by element from global memory (the joints'
// wk and wv, used once per sample a CTA meets)
template <typename E>
struct Global {
  const E* w;
  int ldw;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return Num<E>::to_float(w[i * ldw + j]);
  }
};

// What a mode computes of the row-local part.
template <int kMode>
struct Parts {
  static constexpr bool kCross =
      kMode != LNONLY && kMode != MLPONLY && kMode != NOCROSS;
  static constexpr bool kMlp = kMode != LNONLY && kMode != NOMLP;
  static constexpr bool kSelf =
      kMode != LNONLY && kMode != MLPONLY && kMode != NOSELF;
  static constexpr bool kL3 = kMode == PREPROJ || kMode == FOLD1DOT;
  // weight blocks a tile's products take, in order: wq, proj; fc1's four
  // column blocks, fc2's four row blocks; L0, L1, L2; L3
  static constexpr int NBLK =
      (kCross ? 2 : 0) + (kMlp ? 8 : 0) + (kSelf ? 3 : 0) + (kL3 ? 1 : 0);
};

struct WBlock {
  int field, r0, c0, ldw;
};

template <int kMode>
__device__ __forceinline__ WBlock wblock(int i) {
  using M = Parts<kMode>;
  if constexpr (M::kCross) {
    if (i < 2) return {i == 0 ? WQ : PROJ_W, 0, 0, C};
    i -= 2;
  }
  if constexpr (M::kMlp) {
    if (i < 4) return {FC1_W, 0, i * C, HID};
    if (i < 8) return {FC2_W, (i - 4) * C, 0, C};
    i -= 8;
  }
  if constexpr (M::kSelf) {
    if (i < 3) return {L0_W + 2 * i, 0, 0, C};
  }
  return {L3_W, 0, 0, C};
}

// The weight blocks of a CTA's tiles, through two [64, 64] slots: while a
// product reads one, cp.async fills the other with the next block (the
// next tile's first after a tile's last). Four slots, three blocks ahead,
// measured no faster: the staging is not what holds the launch back.
template <typename T, int kMode>
struct WeightRing {
  using S = RowsSmem<T>;
  static constexpr int NBLK = Parts<kMode>::NBLK;
  T* buf;
  const T* p;
  const int* offs;
  long long left;  // blocks not yet fetched
  int blk = 0;     // the next one's index in a tile's sequence
  int cur = 0;     // slot of the block the next product takes

  __device__ WeightRing(unsigned char* sm, const T* p_, const int* offs_,
                        long long tiles)
      : buf(at<T>(sm, S::WS)), p(p_), offs(offs_), left(tiles * NBLK) {
    fetch(0);
  }

  __device__ void fetch(int slot) {
    if (left == 0) return;
    const WBlock w = wblock<kMode>(blk);
    tc::stage(buf + slot * C * S::LT, S::LT,
              p + offs[w.field] + w.r0 * w.ldw + w.c0, w.ldw, C, C);
    tc::cp_async_commit();
    blk = blk + 1 == NBLK ? 0 : blk + 1;
    --left;
  }

  // the next block, once every thread's copy of it has landed and every
  // warp is done with the previous product (whose slot then takes the
  // block after it)
  __device__ const T* next() {
    tc::cp_async_wait<0>();
    __syncthreads();
    const T* ws = buf + cur * C * S::LT;
    cur ^= 1;
    fetch(cur);
    return ws;
  }
};

template <typename T, typename TX>
struct RowsArgs {
  const TX* x;       // [B, Nv, C] layer input
  const T* joints;   // [B, J, C]
  const T* p;        // packed weights
  const int* offs;   // field offsets
  float* y3;         // [B, Nv, C]
  T* q2;             // [B, Nv, C]
  T* k2;
  T* vout;           // [B, Nv, v_width(kMode)]
  T* out;            // [B, Nv, C] (row-local modes)
  int B, Nv, J;
  int nrt;           // row tiles per sample
};

// The joints of sample b: LN1, rounded (rows J.. zero), then their K and
// V, rounded, into KJ and VJ.
template <typename T, typename TX>
__device__ __forceinline__ void joints_kv(const RowsArgs<T, TX>& a,
                                          unsigned char* sm, int b) {
  using S = RowsSmem<T>;
  using N = Num<T>;
  float* JT = at<float>(sm, S::JT);
  T* YJ = at<T>(sm, S::YJ);
  T* KJ = at<T>(sm, S::KJ);
  T* VJ = at<T>(sm, S::VJ);
  const int J = a.J;
  const T* p = a.p;
  const int* o = a.offs;
  for (int i = threadIdx.x; i < J * C; i += NT_ROWS)
    JT[i / C * S::LF + i % C] = N::to_float(a.joints[(size_t)b * J * C + i]);
  for (int i = threadIdx.x; i < (JMAX - J) * C; i += NT_ROWS)
    YJ[(J + i / C) * S::LT + i % C] = N::from_float(0.0f);
  __syncthreads();
  layer_norm_rows<C>(JT, S::LF, J, p + o[LN1_W], p + o[LN1_B], 1e-5f, false,
                     [&](int r, int c, float v) {
                       YJ[r * S::LT + c] = N::from_float(v);
                     });
  __syncthreads();
  tc::gemm<T, 1>(JMAX / 16, C / 8, C, tc::RowMajor<T>{YJ, S::LT},
                 Global<T>{p + o[WK], C},
                 [&](int r, int c, float v, float w) {
                   st2(KJ + r * S::LT + c, v, w);
                 });
  tc::gemm<T, 1>(JMAX / 16, C / 8, C, tc::RowMajor<T>{YJ, S::LT},
                 Global<T>{p + o[WV], C},
                 [&](int r, int c, float v, float w) {
                   st2(VJ + r * S::LT + c, v, w);
                 });
}

// The row-local part of one (sample, TR-row tile). Rows past the last
// vertex are computed from zero inputs (finite) and never written out.
// `jb` is the sample whose joints' K and V are in shared memory.
template <typename T, bool kRoundAll, int kMode, typename TX>
__device__ __forceinline__ void rows_tile(const RowsArgs<T, TX>& a,
                                          unsigned char* sm, int b, int tile,
                                          int& jb,
                                          WeightRing<T, kMode>& w) {
  using S = RowsSmem<T>;
  using M = Parts<kMode>;
  using N = Num<T>;
  using RM = tc::RowMajor<T>;
  constexpr int TR = S::TR, MT = TR / 16, NB = TR / 16;
  constexpr int LF = S::LF, LT = S::LT, LTH = S::LTH;
  const int Nv = a.Nv, J = a.J, tid = threadIdx.x;
  const int r0 = tile * TR;
  const int nr = min(TR, Nv - r0);
  const size_t row0 = (size_t)b * Nv + r0;
  // each weight pointer is taken where it is used: taken up front they
  // stay live through the whole tile, at the cost of the products'
  // registers
  const T* p = a.p;
  const int* o = a.offs;
  float* X = at<float>(sm, S::X);
  float* P = at<float>(sm, S::P);
  T* Y = at<T>(sm, S::Y);
  T* Q = at<T>(sm, S::Q);

  __syncthreads();  // the previous tile is done with every buffer
  if constexpr (M::kCross) {
    if (b != jb) {
      jb = b;
      joints_kv(a, sm, b);
    }
  }
  for (int i = tid; i < TR * C; i += NT_ROWS) {
    const int r = i / C, c = i % C;
    X[r * LF + c] =
        r < nr ? Num<TX>::to_float(a.x[(row0 + r) * C + c]) : 0.0f;
  }
  __syncthreads();

  if constexpr (kMode == LNONLY) {
    // out = y3 + LN2(y3), y3 = StdLN(LN1(x)), all f32 until the output
    layer_norm_rows<C>(X, LF, nr, p + o[LN1_W], p + o[LN1_B], 1e-5f, false,
                       [&](int r, int c, float v) { P[r * LF + c] = v; });
    __syncthreads();
    layer_norm_rows<C>(P, LF, nr, p + o[A2], p + o[B2], 1e-6f, true,
                       [&](int r, int c, float v) { P[r * LF + c] = v; });
    __syncthreads();
    layer_norm_rows<C>(P, LF, nr, p + o[LN2_W], p + o[LN2_B], 1e-5f, false,
                       [&](int r, int c, float v) {
                         a.out[(row0 + r) * C + c] =
                             N::from_float(P[r * LF + c] + v);
                       });
    return;
  }

  if constexpr (M::kCross) {
    // q = T(T(LN1 x) @ wq)
    layer_norm_rows<C>(X, LF, TR, p + o[LN1_W], p + o[LN1_B], 1e-5f, false,
                       [&](int r, int c, float v) {
                         Y[r * LT + c] = N::from_float(v);
                       });
    const T* wq = w.next();
    tc::gemm<T, NB>(MT, C / 8, C, RM{Y, LT}, RM{wq, LT},
                    [&](int r, int c, float v, float w) {
                      st2(Q + r * LT + c, v, w);
                    });
    __syncthreads();
    // scores per head over the J joints (padded to JMAX), the softmax per
    // (row, head) rounded to T, then o = T(P @ V) into Q
    T* PM = at<T>(sm, S::PM);
    const T* KJ = at<T>(sm, S::KJ);
    const T* VJ = at<T>(sm, S::VJ);
#pragma unroll
    for (int h = 0; h < H; ++h)
      tc::gemm<T, 1>(MT, JMAX / 8, D, RM{Q + h * D, LT},
                     tc::ColMajor<T>{KJ + h * D, LT},
                     [&](int r, int m, float v, float w) {
                       st2(P + r * LF + h * JMAX + m, v * kScale,
                           w * kScale);
                     });
    __syncthreads();
    // one warp per (row, head), one lane per joint (zero past J)
    const int lane = tid & 31;
    for (int task = tid >> 5; task < TR * H; task += NT_ROWS / 32) {
      const int r = task / H, col = task % H * JMAX + lane;
      const float sv = lane < J ? P[r * LF + col] : -CUDART_INF_F;
      const float mx = warp_max(sv);
      const float e = lane < J ? expf(sv - mx) : 0.0f;
      PM[r * LT + col] = N::from_float(e / warp_sum(e));
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < H; ++h)
      tc::gemm<T, 1>(MT, D / 8, JMAX, RM{PM + h * JMAX, LT},
                     RM{VJ + h * D, LT},
                     [&](int r, int c, float v, float w) {
                       st2(Q + r * LT + h * D + c, v, w);
                     });
    // x1 = x + (o @ Wproj + b)
    const T* proj = w.next();
    const T* proj_b = p + o[PROJ_B];
    tc::gemm<T, NB>(MT, C / 8, C, RM{Q, LT}, RM{proj, LT},
                    [&](int r, int c, float v, float w) {
                      const float2 b = ld2(proj_b + c);
                      float* x = X + r * LF + c;
                      x[0] += rp<T, kRoundAll>(rp<T, kRoundAll>(v) + b.x);
                      x[1] += rp<T, kRoundAll>(rp<T, kRoundAll>(w) + b.y);
                    });
  } else if constexpr (kMode != MLPONLY) {
    // nocross: x1 = x + proj_b
    const T* proj_b = p + o[PROJ_B];
    for (int i = tid; i < nr * C; i += NT_ROWS)
      X[i / C * LF + i % C] += ld(proj_b + i % C);
  }
  __syncthreads();

  // x2 = x1 + fc2(act(fc1(T(LN2 x1))))
  layer_norm_rows<C>(X, LF, TR, p + o[LN2_W], p + o[LN2_B], 1e-5f, false,
                     [&](int r, int c, float v) {
                       Y[r * LT + c] = N::from_float(v);
                     });
  if constexpr (kMode == NOMLP) {
    // the hidden is zero: fc2 adds its bias
    __syncthreads();
    const T* fc2_b = p + o[FC2_B];
    for (int i = tid; i < nr * C; i += NT_ROWS)
      X[i / C * LF + i % C] += ld(fc2_b + i % C);
  } else {
    T* H1 = at<T>(sm, S::H1);
    float* ACC = at<float>(sm, S::ACC);
    const T* fc1_b = p + o[FC1_B];
    for (int nb = 0; nb < HID / C; ++nb) {  // fc1's four column blocks
      const T* fc1 = w.next();
      tc::gemm<T, NB>(MT, C / 8, C, RM{Y, LT}, RM{fc1, LT},
                      [&](int r, int cc, float v, float w) {
                        const int c = nb * C + cc;
                        const float2 b = ld2(fc1_b + c);
                        st2(H1 + r * LTH + c,
                            activation<T, kRoundAll, kMode>(v, b.x),
                            activation<T, kRoundAll, kMode>(w, b.y));
                      });
    }
    const T* fc2_b = p + o[FC2_B];
    for (int kb = 0; kb < HID / C; ++kb) {  // fc2's four row blocks
      const T* fc2 = w.next();
      tc::gemm<T, NB>(MT, C / 8, C, RM{H1 + kb * C, LTH}, RM{fc2, LT},
                      [&](int r, int c, float v, float w) {
                        float* acc = ACC + r * LF + c;
                        if (kb > 0) {
                          v += acc[0];
                          w += acc[1];
                        }
                        if (kb + 1 < HID / C) {
                          st2(acc, v, w);
                          return;
                        }
                        const float2 b = ld2(fc2_b + c);
                        float* x = X + r * LF + c;
                        x[0] += rp<T, kRoundAll>(rp<T, kRoundAll>(v) + b.x);
                        x[1] += rp<T, kRoundAll>(rp<T, kRoundAll>(w) + b.y);
                      });
    }
  }
  __syncthreads();
  if constexpr (kMode == MLPONLY) {
    // out = x + fc2(gelu(fc1(T(LN2 x))))
    for (int i = tid; i < nr * C; i += NT_ROWS)
      a.out[row0 * C + i] = N::from_float(X[i / C * LF + i % C]);
    return;
  }

  // y3 = StdLN(x2); rounded for L0/L1/L2 (and, under kRoundAll, for the
  // residual too)
  const T* l3_b = p + o[L3_B];
  layer_norm_rows<C>(X, LF, TR, p + o[A2], p + o[B2], 1e-6f, true,
                     [&](int r, int c, float v) {
                       const size_t i = (row0 + r) * C + c;
                       if constexpr (kMode == NOSELF) {
                         if (r < nr)
                           a.out[i] = N::from_float(v + ld(l3_b + c));
                       } else {
                         if (r < nr) a.y3[i] = rp<T, kRoundAll>(v);
                         Y[r * LT + c] = N::from_float(v);
                       }
                     });
  if constexpr (kMode == NOSELF) return;
  T* const outs[2] = {a.q2, a.k2};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T* wl = w.next();
    const T* bias = p + o[L0_B + 2 * i];
    tc::gemm<T, NB>(MT, C / 8, C, RM{Y, LT}, RM{wl, LT},
                    [&](int r, int c, float v, float w) {
                      const float2 b = ld2(bias + c);
                      if (r < nr)
                        st2(outs[i] + (row0 + r) * C + c,
                            rp<T, kRoundAll>(v) + b.x,
                            rp<T, kRoundAll>(w) + b.y);
                    });
  }
  const T* l2 = w.next();
  const T* l2_b = p + o[L2_B];
  if constexpr (M::kL3) {
    // T(v2) into Q, then through L3: preproj T((T(v2) @ L3) / H), the same
    // row for both heads; fold1dot T(T(v2_h) @ L3[h rows]) per head
    tc::gemm<T, NB>(MT, C / 8, C, RM{Y, LT}, RM{l2, LT},
                    [&](int r, int c, float v, float w) {
                      const float2 b = ld2(l2_b + c);
                      st2(Q + r * LT + c, v + b.x, w + b.y);
                    });
    const T* l3 = w.next();
    if constexpr (kMode == PREPROJ) {
      tc::gemm<T, NB>(MT, C / 8, C, RM{Q, LT}, RM{l3, LT},
                      [&](int r, int c, float v, float w) {
                        if (r < nr)
                          st2(a.vout + (row0 + r) * C + c, v * (1.0f / H),
                              w * (1.0f / H));
                      });
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h)
        tc::gemm<T, NB>(MT, C / 8, D, RM{Q + h * D, LT},
                        RM{l3 + h * D * LT, LT},
                        [&](int r, int c, float v, float w) {
                          if (r < nr)
                            st2(a.vout + (row0 + r) * (H * C) + h * C + c, v,
                                w);
                        });
    }
  } else {
    tc::gemm<T, NB>(MT, C / 8, C, RM{Y, LT}, RM{l2, LT},
                    [&](int r, int c, float v, float w) {
                      const float2 b = ld2(l2_b + c);
                      if (r < nr)
                        st2(a.vout + (row0 + r) * C + c,
                            rp<T, kRoundAll>(v) + b.x,
                            rp<T, kRoundAll>(w) + b.y);
                    });
  }
}

// x: TX [B, Nv, C]; joints: T [B, J, C]. Writes y3 (f32), q2, k2 (T
// [B, Nv, C]) and v (T [B, Nv, v_width(kMode)]); the row-local modes write
// out (T) alone. Each CTA walks a contiguous run of the B * nrt (sample,
// tile) items, so a sample's joints are prepared once per CTA that meets
// it and the weight ring runs on across tiles.
template <typename T, bool kRoundAll, int kMode, typename TX = T>
__global__ void __launch_bounds__(NT_ROWS, RowsSmem<T>::MIN_CTAS)
    rows_kernel(RowsArgs<T, TX> a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const long long total = (long long)a.B * a.nrt;
  const long long beg = total * blockIdx.x / gridDim.x;
  const long long end = total * (blockIdx.x + 1) / gridDim.x;
  if (beg >= end) return;
  WeightRing<T, kMode> w(sm, a.p, a.offs, end - beg);
  int jb = -1;
  for (long long t = beg; t < end; ++t)
    rows_tile<T, kRoundAll, kMode, TX>(a, sm, (int)(t / a.nrt),
                                       (int)(t % a.nrt), jb, w);
}

// q . k for one head from a staged f32 key row (the same FMA chain in
// every pass, so a recomputed score equals the first)
__device__ __forceinline__ float dot_head(const float (&q)[D],
                                          const float* k) {
  const float4* kr = reinterpret_cast<const float4*>(k);
  float s = 0.0f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 kv = kr[d4];
    s = fmaf(q[4 * d4], kv.x, s);
    s = fmaf(q[4 * d4 + 1], kv.y, s);
    s = fmaf(q[4 * d4 + 2], kv.z, s);
    s = fmaf(q[4 * d4 + 3], kv.w, s);
  }
  return s;
}

// acc += pr * v[0:AW] (v: a staged f32 V row, 16-byte aligned)
template <int AW>
__device__ __forceinline__ void add_row(float (&acc)[AW], const float* v,
                                        float pr) {
  const float4* vr = reinterpret_cast<const float4*>(v);
#pragma unroll
  for (int d4 = 0; d4 < AW / 4; ++d4) {
    const float4 vv = vr[d4];
    acc[4 * d4] = fmaf(pr, vv.x, acc[4 * d4]);
    acc[4 * d4 + 1] = fmaf(pr, vv.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(pr, vv.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(pr, vv.w, acc[4 * d4 + 3]);
  }
}

// stage keys [k0, k0 + nk) of one sample as f32 into Ks [TK, C] and, with
// kWithV, their V rows into Vs [TK, VW]
template <typename T, int VW, bool kWithV>
__device__ __forceinline__ void stage(const T* __restrict__ k2,
                                      const T* __restrict__ vin, size_t base,
                                      int k0, int nk, float* Ks, float* Vs) {
  __syncthreads();  // the previous tile is read no more
  for (int i = threadIdx.x; i < nk * C; i += NT_ATTN)
    Ks[i] = Num<T>::to_float(k2[(base + k0) * C + i]);
  if constexpr (kWithV) {
    for (int i = threadIdx.x; i < nk * VW; i += NT_ATTN)
      Vs[i] = Num<T>::to_float(vin[(base + k0) * VW + i]);
  }
  __syncthreads();
}

template <int kMode>
constexpr int attn_smem_floats() {
  return TK * C + TK * v_width(kMode) > TQ * C ? TK * C + TK * v_width(kMode)
                                               : TQ * C;
}

// q2, k2: T [B, Nv, C]; vin: T [B, Nv, v_width(kMode)]; y3: f32. Writes
// out (T [B, Nv, C]).
template <typename T, bool kRoundAll, int kMode>
__global__ void __launch_bounds__(NT_ATTN)
    attn_kernel(const T* __restrict__ q2, const T* __restrict__ k2,
                const T* __restrict__ vin, const float* __restrict__ y3,
                const T* __restrict__ p, const int* __restrict__ offs,
                T* __restrict__ out, int b0, int Nv) {
  constexpr int VW = v_width(kMode);
  // preproj and fold1dot add a full C-wide row per key and head
  constexpr bool kWide = kMode == PREPROJ || kMode == FOLD1DOT;
  constexpr int AW = kWide ? C : D;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;          // [TK, C]
  float* Vs = Ks + TK * C;   // [TK, VW]
  float* O = smem;           // [TQ, C] after the key loop

  const int tid = threadIdx.x;
  const int h = tid / TQ;   // warps 0-1: head 0, warps 2-3: head 1
  const int r = tid % TQ;
  const int r0 = blockIdx.x * TQ;
  const int nq = min(TQ, Nv - r0);
  const int row = min(r0 + r, Nv - 1);
  const int vcol = kMode == PREPROJ ? 0 : (kMode == FOLD1DOT ? h * C : h * D);
  const T* l3_b = p + offs[L3_B];

  const int b = b0 + blockIdx.y;
  const size_t base = (size_t)b * Nv;
  float q[D], acc[AW];
#pragma unroll
  for (int d = 0; d < D; ++d)
    q[d] = Num<T>::to_float(q2[(base + row) * C + h * D + d]);
#pragma unroll
  for (int d = 0; d < AW; ++d) acc[d] = 0.0f;

  if constexpr (kMode == NOSOFTMAX) {
    // prob = T(s * scale / 431), no softmax: one pass
    for (int k0 = 0; k0 < Nv; k0 += TK) {
      const int nk = min(TK, Nv - k0);
      stage<T, VW, true>(k2, vin, base, k0, nk, Ks, Vs);
      for (int j = 0; j < nk; ++j)
        add_row(acc, Vs + j * VW + vcol,
                rnd<T>(dot_head(q, Ks + j * C + h * D) * kScaleNoSoftmax));
    }
  } else if constexpr (kMode == BF16SMAX) {
    // the softmax of T(s * scale) in T: max, then the sum of the rounded
    // exponentials, then the rounded quotients (three passes)
    float mx = -CUDART_INF_F;
    for (int k0 = 0; k0 < Nv; k0 += TK) {
      const int nk = min(TK, Nv - k0);
      stage<T, VW, false>(k2, vin, base, k0, nk, Ks, Vs);
      for (int j = 0; j < nk; ++j)
        mx = fmaxf(mx, rnd<T>(dot_head(q, Ks + j * C + h * D) * kScale));
    }
    float l = 0.0f;
    for (int k0 = 0; k0 < Nv; k0 += TK) {
      const int nk = min(TK, Nv - k0);
      stage<T, VW, false>(k2, vin, base, k0, nk, Ks, Vs);
      for (int j = 0; j < nk; ++j) {
        const float st = rnd<T>(dot_head(q, Ks + j * C + h * D) * kScale);
        l += rnd<T>(expf(rnd<T>(st - mx)));
      }
    }
    l = rnd<T>(l);
    for (int k0 = 0; k0 < Nv; k0 += TK) {
      const int nk = min(TK, Nv - k0);
      stage<T, VW, true>(k2, vin, base, k0, nk, Ks, Vs);
      for (int j = 0; j < nk; ++j) {
        const float st = rnd<T>(dot_head(q, Ks + j * C + h * D) * kScale);
        add_row(acc, Vs + j * VW + vcol,
                rnd<T>(rnd<T>(expf(rnd<T>(st - mx))) / l));
      }
    }
  } else {
    // pass 1: the row's max and sum, online; pass 2: T(exp(s - max) /
    // sum) times V
    float mx = -CUDART_INF_F;
    float l = 0.0f;
    for (int k0 = 0; k0 < Nv; k0 += TK) {
      const int nk = min(TK, Nv - k0);
      stage<T, VW, false>(k2, vin, base, k0, nk, Ks, Vs);
      for (int j = 0; j < nk; ++j) {
        const float s = dot_head(q, Ks + j * C + h * D) * kScale;
        if (s > mx) {
          l *= expf(mx - s);
          mx = s;
        }
        l += expf(s - mx);
      }
    }
    for (int k0 = 0; k0 < Nv; k0 += TK) {
      const int nk = min(TK, Nv - k0);
      stage<T, VW, true>(k2, vin, base, k0, nk, Ks, Vs);
      for (int j = 0; j < nk; ++j) {
        const float s = dot_head(q, Ks + j * C + h * D) * kScale;
        add_row(acc, Vs + j * VW + vcol, rnd<T>(expf(s - mx) / l));
      }
    }
  }
  __syncthreads();  // the staged tiles are read no more: O reuses them

  if constexpr (kWide) {
    // out = T((y3 + (acc_0 + acc_1)) + l3_b)
    if (h == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) O[r * C + c] = acc[c];
    }
    __syncthreads();
    if (h == 1 && r < nq) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t i = (base + r0 + r) * C + c;
        out[i] = Num<T>::from_float((y3[i] + (O[r * C + c] + acc[c])) +
                                    ld(l3_b + c));
      }
    }
  } else {
    // o = T(concat_h o_h); x' = y3 + (o @ L3 + b), rounded per the policy
#pragma unroll
    for (int d = 0; d < D; ++d) O[r * C + h * D + d] = rnd<T>(acc[d]);
    __syncthreads();
    gemm<T>(O, C, nq, C, p + offs[L3_W], C, C, [&](int rr, int c, float v) {
      const size_t i = (base + r0 + rr) * C + c;
      out[i] = Num<T>::from_float(
          kRoundAll ? y3[i] + rnd<T>(rnd<T>(v) + ld(l3_b + c))
                    : (y3[i] + v) + ld(l3_b + c));
    });
  }
}

// CTAs of `kern` the device holds at once, or 0
template <typename K>
int rows_wave(K kern, int smem) {
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, NT_ROWS,
                                                    smem) != cudaSuccess)
    return 0;
  return per * sms;
}

template <typename T, bool kRoundAll, int kMode, typename TX = T>
int launch_rows(const void* x, const void* joints, const void* weights,
                const void* offs, void* y3, void* q2, void* k2, void* v,
                void* out, int B, int Nv, int J, cudaStream_t stream) {
  auto kern = rows_kernel<T, kRoundAll, kMode, TX>;
  const int smem = RowsSmem<T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const RowsArgs<T, TX> a{
      static_cast<const TX*>(x), static_cast<const T*>(joints),
      static_cast<const T*>(weights), static_cast<const int*>(offs),
      static_cast<float*>(y3), static_cast<T*>(q2), static_cast<T*>(k2),
      static_cast<T*>(v), static_cast<T*>(out), B, Nv, J,
      (Nv + RowsSmem<T>::TR - 1) / RowsSmem<T>::TR};
  const long long total = (long long)B * a.nrt;
  static int wave = 0;  // per kernel: each mode's registers differ
  if (wave == 0) wave = rows_wave(kern, smem);
  if (wave <= 0) return (int)cudaErrorInvalidConfiguration;
  if (total == 0) return 0;
  kern<<<(int)(total < wave ? total : wave), NT_ROWS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool kRoundAll, int kMode>
int launch_attn(const void* q2, const void* k2, const void* v,
                const void* y3, const void* weights, const void* offs,
                void* out, int B, int Nv, cudaStream_t stream) {
  auto kern = attn_kernel<T, kRoundAll, kMode>;
  const int smem = attn_smem_floats<kMode>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_B) {
    dim3 grid((Nv + TQ - 1) / TQ, B - b0 < MAX_GRID_B ? B - b0 : MAX_GRID_B);
    kern<<<grid, NT_ATTN, smem, stream>>>(
        static_cast<const T*>(q2), static_cast<const T*>(k2),
        static_cast<const T*>(v), static_cast<const float*>(y3),
        static_cast<const T*>(weights), static_cast<const int*>(offs),
        static_cast<T*>(out), b0, Nv);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace lbf_layer
}  // namespace gator
