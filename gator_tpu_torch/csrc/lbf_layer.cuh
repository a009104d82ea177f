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
//   rows_kernel: per (32-row tile, sample): the cross-attention over the J
//                joints, LN2, the MLP, the std-LN and the q2/k2/v2
//                projections (T1's preproj and fold1dot project v2 through
//                L3 here). Row-local modes write the layer's output here.
//   attn_kernel: per (64-query tile, sample), both heads: the softmax over
//                all Nv keys in two passes over 64-key tiles staged in
//                shared memory: the first takes each row's max and sum
//                online, the second recomputes the scores and adds
//                T(exp(s - max) / sum) * V, so the normalised probability
//                is rounded where the TPU kernels round it and no score
//                tile is stored (1.5x K2's QK work). Then L3 and the
//                residual.
// One CTA per (row tile, sample); past the grid's 65535 samples the host
// launches again, so no CTA loops (a loop over samples took the row kernel
// from 80 registers to 112 and cost it 15 % of its time). The ragged Nv edge
// is masked by row counts; the TPU kernels' 431->432 padding, their
// block-diagonal cross mask and the A&S erf polynomial are gone (exact
// erff; the two differ by 1.5e-7).
//
// What bounds it on the H100: FMA on the f32 pipes, as in K2: ~25 MFMA per
// sample in the rows kernel and ~36 MFMA per sample in the self-attention
// at Nv=431 (its QK products done twice). Tensor cores are the next step.
#pragma once

#include "common.cuh"

namespace gator {
namespace lbf_layer {

constexpr int C = 64;     // token width
constexpr int H = 2;      // heads
constexpr int D = 32;     // head width
constexpr int HID = 256;  // MLP hidden
constexpr int JMAX = 32;  // most joint tokens
constexpr int TR = 32;    // vertex rows per rows_kernel CTA
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

constexpr int ROWS_SMEM_FLOATS = 3 * TR * C + TR * HID + 2 * JMAX * C;

// x: TX [B, Nv, C]; joints: T [B, J, C]. Writes y3 (f32), q2, k2 (T
// [B, Nv, C]) and v (T [B, Nv, v_width(kMode)]); the row-local modes write
// out (T) alone.
template <typename T, bool kRoundAll, int kMode, typename TX = T>
__global__ void __launch_bounds__(NT_ROWS)
    rows_kernel(const TX* __restrict__ x, const T* __restrict__ joints,
                const T* __restrict__ p, const int* __restrict__ offs,
                float* __restrict__ y3, T* __restrict__ q2,
                T* __restrict__ k2, T* __restrict__ vout,
                T* __restrict__ out, int b0, int Nv, int J) {
  constexpr bool kCross =
      kMode != LNONLY && kMode != MLPONLY && kMode != NOCROSS;
  extern __shared__ __align__(16) float smem[];
  float* X = smem;          // [TR, C]  residual rows
  float* Y = X + TR * C;    // [TR, C]  LN outputs; scores [TR, H, J]
  float* Qb = Y + TR * C;   // [TR, C]  cross queries; then T(v2)
  float* Hb = Qb + TR * C;  // [TR, HID] normalised joints, o, MLP hidden
  float* Kj = Hb + TR * HID;  // [JMAX, C]
  float* Vj = Kj + JMAX * C;  // [JMAX, C]

  const int r0 = blockIdx.x * TR;
  const int nr = min(TR, Nv - r0);
  const int tid = threadIdx.x;
  // each weight pointer is taken where it is used: taken up front they
  // stay live through the whole kernel, at the cost of the GEMMs' registers
  const int b = b0 + blockIdx.y;
  const size_t row0 = (size_t)b * Nv + r0;
  for (int i = tid; i < nr * C; i += NT_ROWS)
    X[i] = Num<TX>::to_float(x[row0 * C + i]);
  if constexpr (kCross) {
    for (int i = tid; i < J * C; i += NT_ROWS)
      Hb[i] = Num<T>::to_float(joints[(size_t)b * J * C + i]);
  }
  __syncthreads();

  if constexpr (kMode == LNONLY) {
    // out = y3 + LN2(y3), y3 = StdLN(LN1(x)), all f32 until the output
    layer_norm_rows<C>(X, C, nr, p + offs[LN1_W], p + offs[LN1_B], 1e-5f,
                       false, [&](int r, int c, float v) { Y[r * C + c] = v; });
    __syncthreads();
    layer_norm_rows<C>(Y, C, nr, p + offs[A2], p + offs[B2], 1e-6f, true,
                       [&](int r, int c, float v) { Y[r * C + c] = v; });
    __syncthreads();
    layer_norm_rows<C>(Y, C, nr, p + offs[LN2_W], p + offs[LN2_B], 1e-5f,
                       false, [&](int r, int c, float v) {
                         out[(row0 + r) * C + c] =
                             Num<T>::from_float(Y[r * C + c] + v);
                       });
    return;
  }
  if constexpr (kMode == MLPONLY) {
    // out = x + fc2(gelu(fc1(T(LN2 x))))
    layer_norm_rows<C>(X, C, nr, p + offs[LN2_W], p + offs[LN2_B], 1e-5f,
                       false, [&](int r, int c, float v) {
                         Y[r * C + c] = rnd<T>(v);
                       });
    __syncthreads();
    const T* fc1_b = p + offs[FC1_B];
    gemm<T>(Y, C, nr, C, p + offs[FC1_W], HID, HID,
            [&](int r, int c, float v) {
              Hb[r * HID + c] = rnd<T>(gelu_exact(v + ld(fc1_b + c)));
            });
    __syncthreads();
    const T* fc2_b = p + offs[FC2_B];
    gemm<T>(Hb, HID, nr, HID, p + offs[FC2_W], C, C,
            [&](int r, int c, float v) {
              out[(row0 + r) * C + c] =
                  Num<T>::from_float(X[r * C + c] + (v + ld(fc2_b + c)));
            });
    return;
  }

  if constexpr (kCross) {
    const T* ln1_w = p + offs[LN1_W];
    const T* ln1_b = p + offs[LN1_B];
    layer_norm_rows<C>(Hb, C, J, ln1_w, ln1_b, 1e-5f, false,
                       [&](int r, int c, float v) {
                         Hb[r * C + c] = rnd<T>(v);
                       });
    layer_norm_rows<C>(X, C, nr, ln1_w, ln1_b, 1e-5f, false,
                       [&](int r, int c, float v) {
                         Y[r * C + c] = rnd<T>(v);
                       });
    __syncthreads();
    gemm<T>(Hb, C, J, C, p + offs[WK], C, C,
            [&](int r, int c, float v) { Kj[r * C + c] = rnd<T>(v); });
    gemm<T>(Hb, C, J, C, p + offs[WV], C, C,
            [&](int r, int c, float v) { Vj[r * C + c] = rnd<T>(v); });
    gemm<T>(Y, C, nr, C, p + offs[WQ], C, C,
            [&](int r, int c, float v) { Qb[r * C + c] = rnd<T>(v); });
    __syncthreads();

    // scores [r, h, m] into Y, then the normalised probabilities in T
    float* S = Y;
    for (int i = tid; i < nr * H * J; i += NT_ROWS) {
      const int m = i % J;
      const int h = (i / J) % H;
      const int r = i / (J * H);
      const float* q = Qb + r * C + h * D;
      const float* k = Kj + m * C + h * D;
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q[d], k[d], s);
      S[i] = s * kScale;
    }
    __syncthreads();
    for (int i = tid; i < nr * H; i += NT_ROWS) {
      float* srow = S + i * J;
      float mx = -CUDART_INF_F;
      for (int m = 0; m < J; ++m) mx = fmaxf(mx, srow[m]);
      float sum = 0.0f;
      for (int m = 0; m < J; ++m) sum += expf(srow[m] - mx);
      for (int m = 0; m < J; ++m) srow[m] = rnd<T>(expf(srow[m] - mx) / sum);
    }
    __syncthreads();
    // o = T(P @ V) into Hb (the normalised joints are no longer needed)
    for (int i = tid; i < nr * C; i += NT_ROWS) {
      const int r = i / C;
      const int c = i % C;
      const float* pr = S + (r * H + c / D) * J;
      float o = 0.0f;
      for (int m = 0; m < J; ++m) o = fmaf(pr[m], Vj[m * C + c], o);
      Hb[i] = rnd<T>(o);
    }
    __syncthreads();
    // x1 = x + (o @ Wproj + b)
    const T* proj_b = p + offs[PROJ_B];
    gemm<T>(Hb, C, nr, C, p + offs[PROJ_W], C, C,
            [&](int r, int c, float v) {
              X[r * C + c] +=
                  rp<T, kRoundAll>(rp<T, kRoundAll>(v) + ld(proj_b + c));
            });
  } else {
    // nocross: x1 = x + proj_b
    const T* proj_b = p + offs[PROJ_B];
    for (int i = tid; i < nr * C; i += NT_ROWS) X[i] += ld(proj_b + i % C);
  }
  __syncthreads();

  // x2 = x1 + fc2(act(fc1(T(LN2 x1))))
  layer_norm_rows<C>(X, C, nr, p + offs[LN2_W], p + offs[LN2_B], 1e-5f, false,
                     [&](int r, int c, float v) { Y[r * C + c] = rnd<T>(v); });
  __syncthreads();
  if constexpr (kMode == NOMLP) {
    // the hidden is zero: fc2 adds its bias
    const T* fc2_b = p + offs[FC2_B];
    for (int i = tid; i < nr * C; i += NT_ROWS) X[i] += ld(fc2_b + i % C);
  } else {
    const T* fc1_b = p + offs[FC1_B];
    gemm<T>(Y, C, nr, C, p + offs[FC1_W], HID, HID,
            [&](int r, int c, float v) {
              Hb[r * HID + c] =
                  rnd<T>(activation<T, kRoundAll, kMode>(v, ld(fc1_b + c)));
            });
    __syncthreads();
    const T* fc2_b = p + offs[FC2_B];
    gemm<T>(Hb, HID, nr, HID, p + offs[FC2_W], C, C,
            [&](int r, int c, float v) {
              X[r * C + c] +=
                  rp<T, kRoundAll>(rp<T, kRoundAll>(v) + ld(fc2_b + c));
            });
  }
  __syncthreads();

  // y3 = StdLN(x2); rounded for L0/L1/L2 (and, under kRoundAll, for the
  // residual too)
  const T* l3_b = p + offs[L3_B];
  layer_norm_rows<C>(X, C, nr, p + offs[A2], p + offs[B2], 1e-6f, true,
                     [&](int r, int c, float v) {
                       const size_t i = (row0 + r) * C + c;
                       if constexpr (kMode == NOSELF) {
                         out[i] = Num<T>::from_float(v + ld(l3_b + c));
                       } else {
                         y3[i] = rp<T, kRoundAll>(v);
                         Y[r * C + c] = rnd<T>(v);
                       }
                     });
  if constexpr (kMode == NOSELF) return;
  __syncthreads();
  const T* l0_b = p + offs[L0_B];
  const T* l1_b = p + offs[L1_B];
  const T* l2_b = p + offs[L2_B];
  gemm<T>(Y, C, nr, C, p + offs[L0_W], C, C, [&](int r, int c, float v) {
    q2[(row0 + r) * C + c] =
        Num<T>::from_float(rp<T, kRoundAll>(v) + ld(l0_b + c));
  });
  gemm<T>(Y, C, nr, C, p + offs[L1_W], C, C, [&](int r, int c, float v) {
    k2[(row0 + r) * C + c] =
        Num<T>::from_float(rp<T, kRoundAll>(v) + ld(l1_b + c));
  });
  if constexpr (kMode == PREPROJ || kMode == FOLD1DOT) {
    // T(v2) into Qb, then through L3: preproj T((T(v2) @ L3) / H), the
    // same row for both heads; fold1dot T(T(v2_h) @ L3[h rows]) per head
    gemm<T>(Y, C, nr, C, p + offs[L2_W], C, C, [&](int r, int c, float v) {
      Qb[r * C + c] = rnd<T>(v + ld(l2_b + c));
    });
    __syncthreads();
    const T* l3_w = p + offs[L3_W];
    if constexpr (kMode == PREPROJ) {
      gemm<T>(Qb, C, nr, C, l3_w, C, C, [&](int r, int c, float v) {
        vout[(row0 + r) * C + c] = Num<T>::from_float(v * (1.0f / H));
      });
    } else {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        gemm<T>(Qb + h * D, C, nr, D, l3_w + h * D * C, C, C,
                [&](int r, int c, float v) {
                  vout[(row0 + r) * (H * C) + h * C + c] =
                      Num<T>::from_float(v);
                });
      }
    }
  } else {
    gemm<T>(Y, C, nr, C, p + offs[L2_W], C, C, [&](int r, int c, float v) {
      vout[(row0 + r) * C + c] =
          Num<T>::from_float(rp<T, kRoundAll>(v) + ld(l2_b + c));
    });
  }
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

template <typename T, bool kRoundAll, int kMode, typename TX = T>
int launch_rows(const void* x, const void* joints, const void* weights,
                const void* offs, void* y3, void* q2, void* k2, void* v,
                void* out, int B, int Nv, int J, cudaStream_t stream) {
  auto kern = rows_kernel<T, kRoundAll, kMode, TX>;
  const int smem = ROWS_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_B) {
    dim3 grid((Nv + TR - 1) / TR, B - b0 < MAX_GRID_B ? B - b0 : MAX_GRID_B);
    kern<<<grid, NT_ROWS, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const T*>(joints),
        static_cast<const T*>(weights), static_cast<const int*>(offs),
        static_cast<float*>(y3), static_cast<T*>(q2), static_cast<T*>(k2),
        static_cast<T*>(v), static_cast<T*>(out), b0, Nv, J);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
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
