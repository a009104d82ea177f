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
//   forward   lbf_rows_fwd   per 32-row tile: cross-attention, MLP,
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
//             lbf_rows_bwd   per 32-row tile: recomputes the row-local
//                            forward, backpropagates to dx, and leaves its
//                            tile's share of the joints' dk/dv;
//             lbf_joints_bwd per sample: sums those shares, LN1 backward
//                            of the joint rows -> djoints;
//             reduce         sums the per-CTA parameter-gradient rows.
// No launch holds a probability matrix; dS = P * (M * dP - D) per tile.
// Parameter gradients go to a per-CTA partial row (grid-stride launches
// with a fixed grid) and are summed in a fixed order: repeat runs are
// bit-identical.
//
// What bounds it on the H100: the FMA pipes. ~50 MFMA per layer and
// sample forward, 24 M of it the 431 x 431 self-attention; the backward
// recomputes and does ~2x the forward, all in f32 FMA loops (tensor cores
// are the next step).
#include "train_ops.cuh"

namespace gator {
namespace ltrain {

constexpr int C = 64;     // token width
constexpr int H = 2;      // heads
constexpr int D = 32;     // head width
constexpr int HID = 256;  // MLP hidden
constexpr int JMAX = 32;  // most joint tokens
constexpr int HJ = H * JMAX;
constexpr int TR = 32;    // vertex rows per rows-kernel tile
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

// CTA scratch: vertex-row buffers of [TR, width] f32, then joint buffers
// of [JMAX, C].
enum Buf {
  B_X, B_YV, B_Q, B_P, B_MA, B_A1, B_X1, B_Y2, B_PRE, B_H1D, B_X2, B_Y3,
  B_DY3, B_DX2, B_DH2, B_DH1, B_DY2, B_DX1, B_DO, B_DA1, B_DS, B_DQ, B_DYV,
  B_DX, B_STATS, NROWBUF
};
enum JBuf { J_JT, J_YJ, J_KJ, J_VJ, J_DK, J_DV, J_DYJ, J_STATS, NJBUF };

__host__ __device__ constexpr int bw(int b) {
  return (b == B_P || b == B_MA || b == B_DS)         ? HJ
         : (b == B_PRE || b == B_H1D || b == B_DH1)   ? HID
         : b == B_STATS                               ? 4
                                                      : C;
}

__host__ __device__ constexpr int boff(int b) {
  return b == 0 ? 0 : boff(b - 1) + bw(b - 1) * TR;
}

__host__ __device__ constexpr int jw(int b) { return b == J_STATS ? 4 : C; }

__host__ __device__ constexpr int joff(int b) {
  return b == 0 ? boff(NROWBUF) : joff(b - 1) + jw(b - 1) * JMAX;
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
  float* djk;        // [B, ntiles, J, C] per-tile shares of the joints' dk
  float* djv;        // and dv
  float* scratch;    // per-CTA scratch (SCRATCH_FLOATS each)
  float* part;       // per-CTA gradient partial rows (pstride each)
  long long pstride;
  float* masks;      // mask export (forward; may be null)
  int B, Nv, J, ntiles;
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

__device__ __forceinline__ float* sb(float* S, int b) { return S + boff(b); }
__device__ __forceinline__ float* sj(float* S, int b) { return S + joff(b); }

// The row-local forward of one (sample, tile): leaves every intermediate
// the backward reads in S. fwd: write y3/q2/k2/v2 and export masks.
template <typename T>
__device__ void rows_fwd(const Args<T>& a, float* S, int b, int tile,
                         bool fwd) {
  const int Nv = a.Nv, J = a.J;
  const int r0 = tile * TR;
  const int nr = min(TR, Nv - r0);
  const size_t row0 = (size_t)b * Nv + r0;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  float* X = sb(S, B_X);
  float* YV = sb(S, B_YV);
  float* Q = sb(S, B_Q);
  float* P = sb(S, B_P);
  float* MA = sb(S, B_MA);
  float* A1 = sb(S, B_A1);
  float* X1 = sb(S, B_X1);
  float* Y2 = sb(S, B_Y2);
  float* PRE = sb(S, B_PRE);
  float* H1D = sb(S, B_H1D);
  float* X2 = sb(S, B_X2);
  float* Y3 = sb(S, B_Y3);
  float* JT = sj(S, J_JT);
  float* YJ = sj(S, J_YJ);
  float* KJ = sj(S, J_KJ);
  float* VJ = sj(S, J_VJ);
  const float scale = rsqrtf((float)D);
  const bool dump = fwd && a.masks != nullptr;
  const Export<T> ex(a);

  for (int i = tid; i < nr * C; i += NT)
    X[i] = Num<T>::to_float(a.x[row0 * C + i]);
  for (int i = tid; i < J * C; i += NT)
    JT[i] = Num<T>::to_float(a.jt[(size_t)b * J * C + i]);
  __syncthreads();
  layer_norm_rows<C>(X, C, nr, p + o[N1_W], p + o[N1_B], 1e-5f, false,
                     [&](int r, int c, float v) { YV[r * C + c] = v; });
  layer_norm_rows<C>(JT, C, J, p + o[N1_W], p + o[N1_B], 1e-5f, false,
                     [&](int r, int c, float v) { YJ[r * C + c] = v; });
  __syncthreads();
  gemm_nn<T, 2>(YV, C, nr, C, p + o[WQ], C, C,
                [&](int r, int c, float v) { Q[r * C + c] = v; });
  gemm_nn<T, 2>(YJ, C, J, C, p + o[WK], C, C,
                [&](int r, int c, float v) { KJ[r * C + c] = v; });
  gemm_nn<T, 2>(YJ, C, J, C, p + o[WV], C, C,
                [&](int r, int c, float v) { VJ[r * C + c] = v; });
  __syncthreads();

  // cross-attention over the J joint keys: scores per (row, head, key),
  // softmax and masks per (row, head), the output per (row, column)
  for (int i = tid; i < nr * H * J; i += NT) {
    const int m = i % J;
    const int h = i / J % H;
    const int r = i / (J * H);
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d)
      s = fmaf(rnd<T>(Q[r * C + h * D + d]), rnd<T>(KJ[m * C + h * D + d]),
               s);
    P[r * HJ + h * JMAX + m] = s * scale;
  }
  __syncthreads();
  for (int task = tid; task < H * nr; task += NT) {
    const int h = task / nr;
    const int r = task % nr;
    const int n = r0 + r;
    const uint32_t key = stream_key(a.seed, a.unit, b, M_ATTN0 + h);
    float* prow = P + r * HJ + h * JMAX;
    float* mrow = MA + r * HJ + h * JMAX;
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
      mrow[m] = mk;
      if (dump)
        a.masks[ex.attn + (((size_t)b * H + h) * Nv + n) * J + m] = mk;
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int h = c / D;
    const float* prow = P + r * HJ + h * JMAX;
    const float* mrow = MA + r * HJ + h * JMAX;
    float acc = 0.0f;
    for (int m = 0; m < J; ++m)
      acc = fmaf(rnd<T>(prow[m] * mrow[m]), rnd<T>(VJ[m * C + c]), acc);
    A1[i] = acc;
  }
  __syncthreads();

  // x1 = x + DropPath1(ProjDrop(a1 @ proj + b))
  const T* proj_b = p + o[PROJ_B];
  const float dp1 = drop(stream_key(a.seed, a.unit, b, M_DP1), 0, a.path);
  if (dump && tile == 0 && tid == 0) a.masks[ex.dp1 + b] = dp1;
  const uint32_t kproj = stream_key(a.seed, a.unit, b, M_PROJ);
  gemm_nn<T, 2>(A1, C, nr, C, p + o[PROJ_W], C, C, [&](int r, int c,
                                                       float v) {
    const int n = r0 + r;
    const float mk = drop(kproj, n * C + c, a.proj);
    if (dump) a.masks[ex.proj + ((size_t)b * Nv + n) * C + c] = mk;
    X1[r * C + c] = X[r * C + c] + (v + ld(proj_b + c)) * mk * dp1;
  });
  __syncthreads();
  layer_norm_rows<C>(X1, C, nr, p + o[N2_W], p + o[N2_B], 1e-5f, false,
                     [&](int r, int c, float v) { Y2[r * C + c] = v; });
  __syncthreads();
  const T* fc1_b = p + o[FC1_B];
  const uint32_t kmlp1 = stream_key(a.seed, a.unit, b, M_MLP1);
  gemm_nn<T>(Y2, C, nr, C, p + o[FC1_W], HID, HID, [&](int r, int c, float v) {
    const int n = r0 + r;
    const float pre = v + ld(fc1_b + c);
    const float mk = drop(kmlp1, n * HID + c, a.mlp);
    if (dump) a.masks[ex.mlp1 + ((size_t)b * Nv + n) * HID + c] = mk;
    PRE[r * HID + c] = pre;
    H1D[r * HID + c] = gelu_exact(pre) * mk;
  });
  __syncthreads();
  // x2 = x1 + DropPath2(MlpDrop(h1d @ fc2 + b))
  const T* fc2_b = p + o[FC2_B];
  const float dp2 = drop(stream_key(a.seed, a.unit, b, M_DP2), 0, a.path);
  if (dump && tile == 0 && tid == 0) a.masks[ex.dp2 + b] = dp2;
  const uint32_t kmlp2 = stream_key(a.seed, a.unit, b, M_MLP2);
  gemm_nn<T, 2>(H1D, HID, nr, HID, p + o[FC2_W], C, C,
                [&](int r, int c, float v) {
               const int n = r0 + r;
               const float mk = drop(kmlp2, n * C + c, a.mlp);
               if (dump) a.masks[ex.mlp2 + ((size_t)b * Nv + n) * C + c] = mk;
               X2[r * C + c] = X1[r * C + c] + (v + ld(fc2_b + c)) * mk * dp2;
             });
  __syncthreads();
  layer_norm_rows<C>(X2, C, nr, p + o[A2W], p + o[B2W], 1e-6f, true,
                     [&](int r, int c, float v) {
                       Y3[r * C + c] = v;
                       if (fwd) a.y3[(row0 + r) * C + c] = v;
                     });
  __syncthreads();
  if (!fwd) return;
  const T* l0_b = p + o[L0_B];
  const T* l1_b = p + o[L1_B];
  const T* l2_b = p + o[L2_B];
  gemm_nn<T, 2>(Y3, C, nr, C, p + o[L0_W], C, C, [&](int r, int c, float v) {
    a.q2[(row0 + r) * C + c] = v + ld(l0_b + c);
  });
  gemm_nn<T, 2>(Y3, C, nr, C, p + o[L1_W], C, C, [&](int r, int c, float v) {
    a.k2[(row0 + r) * C + c] = v + ld(l1_b + c);
  });
  gemm_nn<T, 2>(Y3, C, nr, C, p + o[L2_W], C, C, [&](int r, int c, float v) {
    a.v2[(row0 + r) * C + c] = v + ld(l2_b + c);
  });
}

template <typename T>
__global__ void __launch_bounds__(NT) lbf_rows_fwd_kernel(Args<T> a) {
  float* S = a.scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  for (int t = blockIdx.x; t < a.B * a.ntiles; t += gridDim.x) {
    rows_fwd(a, S, t / a.ntiles, t % a.ntiles, true);
    __syncthreads();
  }
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
// head; one 32-row tile per step of a grid-stride loop.
template <typename T>
__global__ void __launch_bounds__(NT) lbf_out_bwd_kernel(Args<T> a) {
  float* S = a.scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  float* PG = a.part + (size_t)blockIdx.x * a.pstride;
  float* DSA = sb(S, B_DY3);
  const int Nv = a.Nv;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  for (int t = blockIdx.x; t < a.B * a.ntiles; t += gridDim.x) {
    const int b = t / a.ntiles;
    const int r0 = t % a.ntiles * TR;
    const int nr = min(TR, Nv - r0);
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

// The row-local backward of one (sample, tile), after rows_fwd.
template <typename T>
__device__ void rows_bwd(const Args<T>& a, float* S, float* PG, int b,
                         int tile) {
  const int Nv = a.Nv, J = a.J;
  const int r0 = tile * TR;
  const int nr = min(TR, Nv - r0);
  const size_t row0 = (size_t)b * Nv + r0;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  float* X = sb(S, B_X);
  float* YV = sb(S, B_YV);
  float* Q = sb(S, B_Q);
  float* P = sb(S, B_P);
  float* MA = sb(S, B_MA);
  float* A1 = sb(S, B_A1);
  float* X1 = sb(S, B_X1);
  float* Y2 = sb(S, B_Y2);
  float* PRE = sb(S, B_PRE);
  float* H1D = sb(S, B_H1D);
  float* X2 = sb(S, B_X2);
  float* Y3 = sb(S, B_Y3);
  float* DY3 = sb(S, B_DY3);
  float* DX2 = sb(S, B_DX2);
  float* DH2 = sb(S, B_DH2);
  float* DH1 = sb(S, B_DH1);
  float* DY2 = sb(S, B_DY2);
  float* DX1 = sb(S, B_DX1);
  float* DO = sb(S, B_DO);
  float* DA1 = sb(S, B_DA1);
  float* DS = sb(S, B_DS);
  float* DQ = sb(S, B_DQ);
  float* DYV = sb(S, B_DYV);
  float* DX = sb(S, B_DX);
  float* STATS = sb(S, B_STATS);
  float* KJ = sj(S, J_KJ);
  float* VJ = sj(S, J_VJ);
  const float scale = rsqrtf((float)D);
  const float* dq2 = a.dq2 + row0 * C;
  const float* dk2 = a.dk2 + row0 * C;
  const float* dv2 = a.dv2 + row0 * C;

  // out = y3 + ...: dy3 = g + dq2 L0^T + dk2 L1^T + dv2 L2^T
  for (int i = tid; i < nr * C; i += NT)
    DY3[i] = Num<T>::to_float(a.gout[row0 * C + i]);
  __syncthreads();
  gemm_nt<T, 2>(dq2, C, nr, C, p + o[L0_W], C, C,
                [&](int r, int k, float v) { DY3[r * C + k] += v; });
  gemm_nt<T, 2>(dk2, C, nr, C, p + o[L1_W], C, C,
                [&](int r, int k, float v) { DY3[r * C + k] += v; });
  gemm_nt<T, 2>(dv2, C, nr, C, p + o[L2_W], C, C,
                [&](int r, int k, float v) { DY3[r * C + k] += v; });
  gemm_tn_acc<T, 4>(Y3, C, dq2, C, nr, C, C, PG + o[L0_W], C);
  gemm_tn_acc<T, 4>(Y3, C, dk2, C, nr, C, C, PG + o[L1_W], C);
  gemm_tn_acc<T, 4>(Y3, C, dv2, C, nr, C, C, PG + o[L2_W], C);
  colsum_acc(dq2, C, nr, C, PG + o[L0_B]);
  colsum_acc(dk2, C, nr, C, PG + o[L1_B]);
  colsum_acc(dv2, C, nr, C, PG + o[L2_B]);
  __syncthreads();
  // y3 = StdLN(x2)
  stdln_bwd_rows<C>(DY3, C, X2, C, nr, p + o[A2W], 1e-6f, STATS,
                    [&](int r, int c, float v) { DX2[r * C + c] = v; });
  __syncthreads();
  norm_param_acc(DY3, C, X2, C, STATS, nr, C, PG + o[A2W], PG + o[B2W]);
  // x2 = x1 + dp2 * m2 * h2
  const float dp2 = drop(stream_key(a.seed, a.unit, b, M_DP2), 0, a.path);
  const uint32_t kmlp2 = stream_key(a.seed, a.unit, b, M_MLP2);
  for (int i = tid; i < nr * C; i += NT)
    DH2[i] = DX2[i] * dp2 * drop(kmlp2, (r0 + i / C) * C + i % C, a.mlp);
  __syncthreads();
  // MLP
  const uint32_t kmlp1 = stream_key(a.seed, a.unit, b, M_MLP1);
  gemm_nt<T>(DH2, C, nr, C, p + o[FC2_W], C, HID, [&](int r, int k, float v) {
    DH1[r * HID + k] = v * drop(kmlp1, (r0 + r) * HID + k, a.mlp) *
                       gelu_grad(PRE[r * HID + k]);
  });
  gemm_tn_acc<T>(H1D, HID, DH2, C, nr, HID, C, PG + o[FC2_W], C);
  colsum_acc(DH2, C, nr, C, PG + o[FC2_B]);
  __syncthreads();
  gemm_tn_acc<T>(Y2, C, DH1, HID, nr, C, HID, PG + o[FC1_W], HID);
  colsum_acc(DH1, HID, nr, HID, PG + o[FC1_B]);
  gemm_nt<T, 2>(DH1, HID, nr, HID, p + o[FC1_W], HID, C,
                [&](int r, int k, float v) { DY2[r * C + k] = v; });
  __syncthreads();
  ln_bwd_rows<C>(DY2, C, X1, C, nr, p + o[N2_W], 1e-5f, STATS,
                 [&](int r, int c, float v) {
                   DX1[r * C + c] = DX2[r * C + c] + v;
                 });
  __syncthreads();
  norm_param_acc(DY2, C, X1, C, STATS, nr, C, PG + o[N2_W], PG + o[N2_B]);
  // x1 = x + dp1 * mproj * (a1 @ proj + b)
  const float dp1 = drop(stream_key(a.seed, a.unit, b, M_DP1), 0, a.path);
  const uint32_t kproj = stream_key(a.seed, a.unit, b, M_PROJ);
  for (int i = tid; i < nr * C; i += NT)
    DO[i] = DX1[i] * dp1 * drop(kproj, (r0 + i / C) * C + i % C, a.proj);
  __syncthreads();
  gemm_nt<T, 2>(DO, C, nr, C, p + o[PROJ_W], C, C,
                [&](int r, int k, float v) { DA1[r * C + k] = v; });
  gemm_tn_acc<T, 4>(A1, C, DO, C, nr, C, C, PG + o[PROJ_W], C);
  colsum_acc(DO, C, nr, C, PG + o[PROJ_B]);
  __syncthreads();
  // cross-attention backward: dprob = m * (da . v) per (row, head, key),
  // then ds = p * (dprob - <dprob, p>) * scale per (row, head)
  for (int i = tid; i < nr * H * J; i += NT) {
    const int m = i % J;
    const int h = i / J % H;
    const int r = i / (J * H);
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d)
      s = fmaf(rnd<T>(DA1[r * C + h * D + d]), rnd<T>(VJ[m * C + h * D + d]),
               s);
    DS[r * HJ + h * JMAX + m] = s * MA[r * HJ + h * JMAX + m];
  }
  __syncthreads();
  for (int task = tid; task < H * nr; task += NT) {
    const int h = task / nr;
    const int r = task % nr;
    const float* prow = P + r * HJ + h * JMAX;
    float* dsrow = DS + r * HJ + h * JMAX;
    float dot = 0.0f;
    for (int m = 0; m < J; ++m) dot = fmaf(dsrow[m], prow[m], dot);
    for (int m = 0; m < J; ++m)
      dsrow[m] = prow[m] * (dsrow[m] - dot) * scale;
  }
  __syncthreads();
  for (int i = tid; i < nr * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int h = c / D;
    float s = 0.0f;
    for (int m = 0; m < J; ++m)
      s = fmaf(rnd<T>(DS[r * HJ + h * JMAX + m]), rnd<T>(KJ[m * C + c]), s);
    DQ[i] = s;
  }
  // this tile's share of the joints' dk and dv
  float* djk = a.djk + (((size_t)b * a.ntiles + tile) * J) * C;
  float* djv = a.djv + (((size_t)b * a.ntiles + tile) * J) * C;
  for (int i = tid; i < J * C; i += NT) {
    const int m = i / C;
    const int c = i % C;
    const int h = c / D;
    float sk = 0.0f, sv = 0.0f;
    for (int r = 0; r < nr; ++r) {
      const int pm = r * HJ + h * JMAX + m;
      sk = fmaf(rnd<T>(DS[pm]), rnd<T>(Q[r * C + c]), sk);
      sv = fmaf(rnd<T>(P[pm] * MA[pm]), rnd<T>(DA1[r * C + c]), sv);
    }
    djk[i] = sk;
    djv[i] = sv;
  }
  __syncthreads();
  gemm_nt<T, 2>(DQ, C, nr, C, p + o[WQ], C, C,
                [&](int r, int k, float v) { DYV[r * C + k] = v; });
  gemm_tn_acc<T, 4>(YV, C, DQ, C, nr, C, C, PG + o[WQ], C);
  __syncthreads();
  ln_bwd_rows<C>(DYV, C, X, C, nr, p + o[N1_W], 1e-5f, STATS,
                 [&](int r, int c, float v) {
                   DX[r * C + c] = DX1[r * C + c] + v;
                 });
  __syncthreads();
  norm_param_acc(DYV, C, X, C, STATS, nr, C, PG + o[N1_W], PG + o[N1_B]);
  for (int i = tid; i < nr * C; i += NT)
    a.dx[row0 * C + i] = Num<T>::from_float(DX[i]);
}

// Capped at 128 registers (two CTAs per SM): at its natural 205 one CTA
// fit per SM, and the cap measured faster on the H100 despite its spills.
template <typename T>
__global__ void __launch_bounds__(NT, 2) lbf_rows_bwd_kernel(Args<T> a) {
  float* S = a.scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  float* PG = a.part + (size_t)blockIdx.x * a.pstride;
  for (int t = blockIdx.x; t < a.B * a.ntiles; t += gridDim.x) {
    const int b = t / a.ntiles;
    const int tile = t % a.ntiles;
    rows_fwd(a, S, b, tile, false);
    rows_bwd(a, S, PG, b, tile);
    __syncthreads();
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
      for (int t = 0; t < a.ntiles; ++t) {
        const size_t at = (((size_t)b * a.ntiles + t) * J) * C + i;
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
                  const void* offs, int B, int Nv, int J, unsigned seed,
                  int unit, const unsigned* thr, const float* scl) {
  Args<T> a{};
  a.x = static_cast<const T*>(x);
  a.jt = static_cast<const T*>(jt);
  a.w = static_cast<const T*>(w);
  a.offs = static_cast<const int*>(offs);
  a.B = B;
  a.Nv = Nv;
  a.J = J;
  a.ntiles = (Nv + TR - 1) / TR;
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

// the pointers of one call, in the order of the C interface below
struct Ptrs {
  void *out, *y3, *q2, *k2, *v2, *a2, *lse, *scratch, *masks;
  const void* gout;
  void *dx, *djt, *da2, *dd, *dq2, *dk2, *dv2, *djk, *djv, *part, *grads;
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
  a.scratch = static_cast<float*>(q.scratch);
  a.masks = static_cast<float*>(q.masks);
  lbf_rows_fwd_kernel<T><<<nctas, NT, 0, s>>>(a);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dim3 grid((a.Nv + TQ - 1) / TQ, a.B);
  lbf_sa_fwd_kernel<T><<<grid, NT_SA, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run_bwd(Args<T> a, const Ptrs& q, int nc_out, int nc_rows, int nc_j,
            long long pstride, int ngrad, cudaStream_t s) {
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
  lbf_rows_bwd_kernel<T><<<nc_rows, NT, 0, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  a.part = part + (size_t)(nc_out + nc_rows) * pstride;
  lbf_joints_bwd_kernel<T><<<nc_j, NT, 0, s>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return reduce_partials(part, nc_out + nc_rows + nc_j, pstride, ngrad,
                         static_cast<float*>(q.grads), s);
}

}  // namespace ltrain
}  // namespace gator

using gator::ltrain::Ptrs;

// Floats of scratch per CTA of the rows kernels.
extern "C" int lbf_train_scratch() {
  return (int)gator::ltrain::SCRATCH_FLOATS;
}

// Forward: lbf_rows_fwd (grid-stride, nctas CTAs) then lbf_sa_fwd.
// dtype: 0 = float32, 1 = bfloat16; x, jt, out in that dtype; y3, q2, k2,
// v2, a2 f32 [B, Nv, 64]; lse f32 [B, 2, Nv]. thr/scale pairs in the order
// (attn, proj, path, mlp, self, out). masks (may be null): the export
// buffer, attn [B,H,Nv,J] | proj [B,Nv,C] | dp1 [B] | mlp1 [B,Nv,4C] |
// mlp2 [B,Nv,C] | dp2 [B] | self [B,H,Nv,Nv] | out [B,Nv,C].
extern "C" int lbf_train_fwd(int dtype, const void* x, const void* jt,
                             const void* w, const void* offs, void* out,
                             void* y3, void* q2, void* k2, void* v2, void* a2,
                             void* lse, void* scratch, void* masks, int B,
                             int Nv, int J, int nctas, unsigned seed,
                             int unit, unsigned t0, float s0, unsigned t1,
                             float s1, unsigned t2, float s2, unsigned t3,
                             float s3, unsigned t4, float s4, unsigned t5,
                             float s5, void* stream) {
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
  q.scratch = scratch;
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
// lbf_joints_bwd, then the reduction of the gradient partials (part:
// [nc_out + nc_rows + nc_j, pstride] f32, zeroed by the caller) into grads
// ([ngrad] f32). da2, dd, dq2, dk2, dv2, djk, djv: f32 work buffers.
extern "C" int lbf_train_bwd(
    int dtype, const void* x, const void* jt, const void* w, const void* offs,
    const void* gout, void* q2, void* k2, void* v2, void* a2, void* lse,
    void* dx, void* djt, void* da2, void* dd, void* dq2, void* dk2, void* dv2,
    void* djk, void* djv, void* scratch, void* part, long long pstride,
    void* grads, int ngrad, int B, int Nv, int J, int nc_out, int nc_rows,
    int nc_j, unsigned seed, int unit, unsigned t0, float s0, unsigned t1,
    float s1, unsigned t2, float s2, unsigned t3, float s3, unsigned t4,
    float s4, unsigned t5, float s5, void* stream) {
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
  q.part = part;
  q.grads = grads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::ltrain::run_bwd(
        gator::ltrain::make_args<float>(x, jt, w, offs, B, Nv, J, seed, unit,
                                        thr, scl),
        q, nc_out, nc_rows, nc_j, pstride, ngrad, s);
  return gator::ltrain::run_bwd(
      gator::ltrain::make_args<__nv_bfloat16>(x, jt, w, offs, B, Nv, J, seed,
                                              unit, thr, scl),
      q, nc_out, nc_rows, nc_j, pstride, ngrad, s);
}
