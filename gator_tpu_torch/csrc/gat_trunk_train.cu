// K5: one GAT block in training mode, forward and backward kernels.
//
// Replaces gator_tpu/nn/pallas_gat_train.py:530 `gat_trunk_train` (custom
// VJP `gat_block_train:478`; forward `_fwd_kernel:335`, backward
// `_bwd_kernel:353`). Per block and sample (reference: lib/models/GAT.py):
//   y   = LN1(x)
//   z   = DropPath1(ProjDrop(Proj(AttnDrop(softmax(qk/4 + hop/path bias)) v))
//                   + MGCN(y))
//   x1  = x + XFeat(z)
//   out = x1 + DropPath2(MlpDrop(fc2(MlpDrop(gelu(fc1(LN2(x1)))))))
// with dropout drawn in-kernel from the hash of csrc/dropout.cuh, keyed per
// (seed, 256 + block, sample, mask-id, element), so the backward regenerates
// every mask whatever its tiling. DropPath is one draw per sample.
//
// Design. A CTA walks over groups of G samples (G*J <= 64 token rows),
// grid-striding so the grid stays at most NCTA_MAX CTAs. Each CTA keeps its
// group's activations in a private f32 scratch region in device memory
// (the TPU kernel's VMEM tile; a block's forward intermediates are ~3k
// floats per row, more than shared memory holds for 64 rows). The backward
// recomputes the forward from the saved block input (recompute-in-backward,
// as on the TPU), then backpropagates through MLP, LN2, XFeat, MGCN,
// attention and LN1, writing dx and accumulating the 25 parameter
// gradients and the hop/path-bias gradient into the CTA's own row of an f32
// partial buffer; a second launch sums the rows in a fixed order, so repeat
// runs are bit-identical.
//
// What bounds it on the H100: the FMA pipes. A block is ~5 MFMA per sample
// forward; the backward recomputes it and does ~2x more, all in f32 FMA
// loops (tensor cores are the next step), with the weights (~266k values)
// read from L2 by every CTA and the activations from the CTA's scratch.
#include "train_ops.cuh"

namespace gator {
namespace gtrain {

constexpr int C = 128;    // embed width
constexpr int H = 8;      // heads
constexpr int D = 16;     // head width
constexpr int C3 = 384;   // qkv width
constexpr int HID = 512;  // MLP hidden
constexpr int C2 = 16;    // second XFeat ring width
constexpr int JMAX = 32;  // most joints
constexpr int HJ = H * JMAX;
constexpr int ROWS = 64;  // token rows per group
constexpr int NT = 256;

// Field order of a block's packed weights (gradients: the same offsets,
// then HOP_BIAS); must match BLOCK_PARAM_KEYS in
// gator_tpu_torch/nn/gat_trunk_train.py.
enum Field {
  N1_W, N1_B, QKV_W, QKV_B, PROJ_W, PROJ_B,
  GCN_W0, GCN_W1, GCN_M, GCN_DIAG, GCN_OFF, GCN_B,
  X0_W, X0_B, X1_W, X1_B, BACK_W0, BACK_W1, BACK_B,
  N2_W, N2_B, FC1_W, FC1_B, FC2_W, FC2_B, HOP_BIAS, NFIELD
};

// Scratch buffers, each [ROWS, width] f32; the forward needs those before
// GO, the backward all of them.
enum Buf {
  B_X, B_Y, B_QKV, B_P, B_MA, B_A1, B_TMP, B_G0, B_G1, B_Z, B_F0P, B_F1P,
  B_F0, B_F1, B_X1, B_Y2, B_PRE, B_HHD,
  B_GO, B_DX, B_DMM2, B_DHH, B_DY, B_DF0, B_DF1, B_DF0P, B_DF1P, B_DZ,
  B_DH0, B_DH1, B_DATT, B_DA1, B_DS, B_DQKV, B_STATS, NBUF
};

__host__ __device__ constexpr int bw(int b) {
  return (b == B_QKV || b == B_DQKV)                 ? C3
         : (b == B_P || b == B_MA || b == B_DS)      ? HJ
         : (b == B_F1P || b == B_F1 || b == B_DF1 || b == B_DF1P) ? C2
         : (b == B_PRE || b == B_HHD || b == B_DHH)  ? HID
         : b == B_STATS                              ? 4
                                                     : C;
}

__host__ __device__ constexpr int boff(int b) {
  return b == 0 ? 0 : boff(b - 1) + bw(b - 1);
}

constexpr long long FWD_FLOATS = (long long)boff(B_GO) * ROWS;
constexpr long long BWD_FLOATS = (long long)boff(NBUF) * ROWS;

__device__ __forceinline__ float* buf(float* S, int b) {
  return S + boff(b) * ROWS;
}

template <typename T>
struct Args {
  const T* x;          // [B, J, C] block input
  const float* bias;   // [H, J, J] hop/path bias
  const float* xm;     // [2, J, J] XFeat hop-ring masks
  const T* w;          // packed weights
  const int* offs;     // field offsets (NFIELD; HOP_BIAS in the grad layout)
  const T* gout;       // [B, J, C] output cotangent (backward)
  T* out;              // [B, J, C] forward output / backward dx
  float* scratch;      // per-CTA scratch
  float* part;         // [gridDim.x, pstride] gradient partials (backward)
  long long pstride;
  float* masks;        // mask export (forward; may be null)
  int B, J, G;
  uint32_t seed;
  int unit;
  Drop attn, proj, mlp, path;
};

// One group's forward: every intermediate the backward reads is left in
// S. With a.out set (the forward kernel) the block output is written.
template <typename T>
__device__ void block_fwd(const Args<T>& a, float* S, int s0, int ns,
                          bool write_out) {
  const int J = a.J;
  const int R = ns * J;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  float* X = buf(S, B_X);
  float* Y = buf(S, B_Y);
  float* QKV = buf(S, B_QKV);
  float* P = buf(S, B_P);
  float* MA = buf(S, B_MA);
  float* A1 = buf(S, B_A1);
  float* TMP = buf(S, B_TMP);
  float* G0 = buf(S, B_G0);
  float* G1 = buf(S, B_G1);
  float* Z = buf(S, B_Z);
  float* F0P = buf(S, B_F0P);
  float* F1P = buf(S, B_F1P);
  float* F0 = buf(S, B_F0);
  float* F1 = buf(S, B_F1);
  float* X1 = buf(S, B_X1);
  float* Y2 = buf(S, B_Y2);
  float* PRE = buf(S, B_PRE);
  float* HHD = buf(S, B_HHD);
  const float scale = rsqrtf((float)D);
  const bool dump = write_out && a.masks != nullptr;
  const size_t o_proj = (size_t)a.B * H * J * J;
  const size_t o_dp1 = o_proj + (size_t)a.B * J * C;
  const size_t o_mlp1 = o_dp1 + a.B;
  const size_t o_mlp2 = o_mlp1 + (size_t)a.B * J * HID;
  const size_t o_dp2 = o_mlp2 + (size_t)a.B * J * C;

  const T* xin = a.x + (size_t)s0 * J * C;
  for (int i = tid; i < R * C; i += NT) X[i] = Num<T>::to_float(xin[i]);
  __syncthreads();
  layer_norm_rows<C>(X, C, R, p + o[N1_W], p + o[N1_B], 1e-5f, false,
                     [&](int r, int c, float v) { Y[r * C + c] = v; });
  __syncthreads();
  const T* qkv_b = p + o[QKV_B];
  gemm_nn<T>(Y, C, R, C, p + o[QKV_W], C3, C3, [&](int r, int c, float v) {
    QKV[r * C3 + c] = v + ld(qkv_b + c);
  });
  __syncthreads();

  // attention: one thread per (head, query row) of each sample
  for (int task = tid; task < H * R; task += NT) {
    const int h = task / R;
    const int r = task % R;
    const int g = r / J;
    const int n = r % J;
    const int smp = s0 + g;
    const uint32_t key = stream_key(a.seed, a.unit, smp, M_ATTN0 + h);
    float q[D];
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = rnd<T>(QKV[r * C3 + h * D + d]);
    const float* kb = QKV + g * J * C3 + C + h * D;
    const float* vb = QKV + g * J * C3 + 2 * C + h * D;
    const float* brow = a.bias + (h * J + n) * J;
    float* prow = P + r * HJ + h * J;
    float* mrow = MA + r * HJ + h * J;
    float mx = -CUDART_INF_F;
    for (int m = 0; m < J; ++m) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q[d], rnd<T>(kb[m * C3 + d]), s);
      s = s * scale + brow[m];
      prow[m] = s;
      mx = fmaxf(mx, s);
    }
    float sum = 0.0f;
    for (int m = 0; m < J; ++m) {
      const float e = expf(prow[m] - mx);
      prow[m] = e;
      sum += e;
    }
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.0f;
    for (int m = 0; m < J; ++m) {
      const float pr = prow[m] / sum;
      const float mk = drop(key, n * J + m, a.attn);
      prow[m] = pr;
      mrow[m] = mk;
      if (dump) a.masks[((size_t)smp * H + h) * J * J + n * J + m] = mk;
      const float pd = rnd<T>(pr * mk);
#pragma unroll
      for (int d = 0; d < D; ++d)
        acc[d] = fmaf(pd, rnd<T>(vb[m * C3 + d]), acc[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) A1[r * C + h * D + d] = acc[d];
  }
  __syncthreads();

  // attn = ProjDrop(a1 @ Wproj + b) -> TMP; MGCN's y @ W0, y @ W1
  const T* proj_b = p + o[PROJ_B];
  gemm_nn<T>(A1, C, R, C, p + o[PROJ_W], C, C, [&](int r, int c, float v) {
    const int smp = s0 + r / J;
    const int n = r % J;
    const float mk = drop(stream_key(a.seed, a.unit, smp, M_PROJ), n * C + c,
                          a.proj);
    if (dump) a.masks[o_proj + ((size_t)smp * J + n) * C + c] = mk;
    TMP[r * C + c] = (v + ld(proj_b + c)) * mk;
  });
  gemm_nn<T>(Y, C, R, C, p + o[GCN_W0], C, C,
             [&](int r, int c, float v) { G0[r * C + c] = v; });
  gemm_nn<T>(Y, C, R, C, p + o[GCN_W1], C, C,
             [&](int r, int c, float v) { G1[r * C + c] = v; });
  __syncthreads();

  // z = DropPath1(attn + diag * (M g0) + adj_off @ (M g1) + b)
  const T* gm = p + o[GCN_M];
  const T* gdiag = p + o[GCN_DIAG];
  const T* goff = p + o[GCN_OFF];
  const T* gb = p + o[GCN_B];
  for (int i = tid; i < R * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int g = r / J;
    const int n = r % J;
    const int smp = s0 + g;
    float t = 0.0f;
    for (int m = 0; m < J; ++m)
      t = fmaf(ld(goff + n * J + m),
               rnd<T>(G1[(g * J + m) * C + c] * ld(gm + m * C + c)), t);
    const float gcn = ld(gdiag + n) * (G0[i] * ld(gm + n * C + c)) + t +
                      ld(gb + c);
    const float dp = drop(stream_key(a.seed, a.unit, smp, M_DP1), 0, a.path);
    if (dump && n == 0 && c == 0) a.masks[o_dp1 + smp] = dp;
    Z[i] = (TMP[i] + gcn) * dp;
  }
  __syncthreads();

  // XFeat: ring projections, then the per-sample hop-ring sums
  const T* x0_b = p + o[X0_B];
  const T* x1_b = p + o[X1_B];
  gemm_nn<T>(Z, C, R, C, p + o[X0_W], C, C, [&](int r, int c, float v) {
    F0P[r * C + c] = v + ld(x0_b + c);
  });
  gemm_nn<T>(Z, C, R, C, p + o[X1_W], C2, C2, [&](int r, int c, float v) {
    F1P[r * C2 + c] = v + ld(x1_b + c);
  });
  __syncthreads();
  for (int i = tid; i < R * (C + C2); i += NT) {
    const int r = i / (C + C2);
    const int c = i % (C + C2);
    const int g = r / J;
    const int n = r % J;
    float s = 0.0f;
    if (c < C) {
      const float* mrow = a.xm + n * J;
      for (int m = 0; m < J; ++m)
        s = fmaf(mrow[m], rnd<T>(F0P[(g * J + m) * C + c]), s);
      F0[r * C + c] = s;
    } else {
      const float* mrow = a.xm + J * J + n * J;
      for (int m = 0; m < J; ++m)
        s = fmaf(mrow[m], rnd<T>(F1P[(g * J + m) * C2 + c - C]), s);
      F1[r * C2 + c - C] = s;
    }
  }
  __syncthreads();
  // x1 = x + (f0 @ B0 + f1 @ B1 + b); each element has one owner thread in
  // both products
  const T* back_b = p + o[BACK_B];
  gemm_nn<T>(F0, C, R, C, p + o[BACK_W0], C, C,
             [&](int r, int c, float v) { X1[r * C + c] = v; });
  gemm_nn<T>(F1, C2, R, C2, p + o[BACK_W1], C, C, [&](int r, int c, float v) {
    X1[r * C + c] = X[r * C + c] + (X1[r * C + c] + v + ld(back_b + c));
  });
  __syncthreads();

  // MLP: pre = LN2(x1) @ fc1 + b, hhd = MlpDrop(gelu(pre))
  layer_norm_rows<C>(X1, C, R, p + o[N2_W], p + o[N2_B], 1e-5f, false,
                     [&](int r, int c, float v) { Y2[r * C + c] = v; });
  __syncthreads();
  const T* fc1_b = p + o[FC1_B];
  gemm_nn<T>(Y2, C, R, C, p + o[FC1_W], HID, HID, [&](int r, int c, float v) {
    const int smp = s0 + r / J;
    const int n = r % J;
    const float pre = v + ld(fc1_b + c);
    const float mk = drop(stream_key(a.seed, a.unit, smp, M_MLP1),
                          n * HID + c, a.mlp);
    if (dump) a.masks[o_mlp1 + ((size_t)smp * J + n) * HID + c] = mk;
    PRE[r * HID + c] = pre;
    HHD[r * HID + c] = gelu_exact(pre) * mk;
  });
  __syncthreads();
  if (!write_out) return;

  // out = x1 + DropPath2(MlpDrop(hhd @ fc2 + b))
  const T* fc2_b = p + o[FC2_B];
  T* xo = a.out + (size_t)s0 * J * C;
  gemm_nn<T>(HHD, HID, R, HID, p + o[FC2_W], C, C, [&](int r, int c, float v) {
    const int smp = s0 + r / J;
    const int n = r % J;
    const float mk = drop(stream_key(a.seed, a.unit, smp, M_MLP2), n * C + c,
                          a.mlp);
    const float dp = drop(stream_key(a.seed, a.unit, smp, M_DP2), 0, a.path);
    if (dump) {
      a.masks[o_mlp2 + ((size_t)smp * J + n) * C + c] = mk;
      if (n == 0 && c == 0) a.masks[o_dp2 + smp] = dp;
    }
    xo[r * C + c] =
        Num<T>::from_float(X1[r * C + c] + (v + ld(fc2_b + c)) * mk * dp);
  });
}

// One group's backward, after block_fwd left the intermediates in S
// (gator_tpu/nn/pallas_gat_train.py `_block_bwd:227`).
template <typename T>
__device__ void block_bwd(const Args<T>& a, float* S, int s0, int ns,
                          float* PG) {
  const int J = a.J;
  const int R = ns * J;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  float* X = buf(S, B_X);
  float* Y = buf(S, B_Y);
  float* QKV = buf(S, B_QKV);
  float* P = buf(S, B_P);
  float* MA = buf(S, B_MA);
  float* A1 = buf(S, B_A1);
  float* TMP = buf(S, B_TMP);
  float* G0 = buf(S, B_G0);
  float* G1 = buf(S, B_G1);
  float* Z = buf(S, B_Z);
  float* F0 = buf(S, B_F0);
  float* F1 = buf(S, B_F1);
  float* X1 = buf(S, B_X1);
  float* Y2 = buf(S, B_Y2);
  float* PRE = buf(S, B_PRE);
  float* HHD = buf(S, B_HHD);
  float* DX = buf(S, B_DX);
  float* DMM2 = buf(S, B_DMM2);
  float* DHH = buf(S, B_DHH);
  float* DY = buf(S, B_DY);
  float* DF0 = buf(S, B_DF0);
  float* DF1 = buf(S, B_DF1);
  float* DF0P = buf(S, B_DF0P);
  float* DF1P = buf(S, B_DF1P);
  float* DZ = buf(S, B_DZ);
  float* DH0 = buf(S, B_DH0);
  float* DH1 = buf(S, B_DH1);
  float* DATT = buf(S, B_DATT);
  float* DA1 = buf(S, B_DA1);
  float* DS = buf(S, B_DS);
  float* DQKV = buf(S, B_DQKV);
  float* STATS = buf(S, B_STATS);
  const float scale = rsqrtf((float)D);

  // out = x1 + dp2 * m2 * mm2: dx1 = g, dmm2 = g * dp2 * m2
  const T* gin = a.gout + (size_t)s0 * J * C;
  for (int i = tid; i < R * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int smp = s0 + r / J;
    const int n = r % J;
    const float go = Num<T>::to_float(gin[i]);
    DX[i] = go;
    DMM2[i] = go * drop(stream_key(a.seed, a.unit, smp, M_DP2), 0, a.path) *
              drop(stream_key(a.seed, a.unit, smp, M_MLP2), n * C + c, a.mlp);
  }
  __syncthreads();

  // MLP backward
  gemm_nt<T>(DMM2, C, R, C, p + o[FC2_W], C, HID, [&](int r, int k, float v) {
    const int smp = s0 + r / J;
    const int n = r % J;
    const float mk = drop(stream_key(a.seed, a.unit, smp, M_MLP1),
                          n * HID + k, a.mlp);
    DHH[r * HID + k] = v * mk * gelu_grad(PRE[r * HID + k]);
  });
  gemm_tn_acc<T>(HHD, HID, DMM2, C, R, HID, C, PG + o[FC2_W], C);
  colsum_acc(DMM2, C, R, C, PG + o[FC2_B]);
  __syncthreads();
  gemm_tn_acc<T>(Y2, C, DHH, HID, R, C, HID, PG + o[FC1_W], HID);
  colsum_acc(DHH, HID, R, HID, PG + o[FC1_B]);
  gemm_nt<T>(DHH, HID, R, HID, p + o[FC1_W], HID, C,
             [&](int r, int k, float v) { DY[r * C + k] = v; });
  __syncthreads();
  ln_bwd_rows<C>(DY, C, X1, C, R, p + o[N2_W], 1e-5f, STATS,
                 [&](int r, int c, float v) { DX[r * C + c] += v; });
  __syncthreads();
  norm_param_acc(DY, C, X1, C, STATS, R, C, PG + o[N2_W], PG + o[N2_B]);

  // XFeat backward (dxf = dx1)
  gemm_nt<T>(DX, C, R, C, p + o[BACK_W0], C, C,
             [&](int r, int k, float v) { DF0[r * C + k] = v; });
  gemm_nt<T>(DX, C, R, C, p + o[BACK_W1], C, C2,
             [&](int r, int k, float v) { DF1[r * C2 + k] = v; });
  gemm_tn_acc<T>(F0, C, DX, C, R, C, C, PG + o[BACK_W0], C);
  gemm_tn_acc<T>(F1, C2, DX, C, R, C2, C, PG + o[BACK_W1], C);
  colsum_acc(DX, C, R, C, PG + o[BACK_B]);
  __syncthreads();
  // df0p = m0^T df0, df1p = m1^T df1 (per sample)
  for (int i = tid; i < R * (C + C2); i += NT) {
    const int r = i / (C + C2);
    const int c = i % (C + C2);
    const int g = r / J;
    const int m = r % J;
    float s = 0.0f;
    if (c < C) {
      for (int n = 0; n < J; ++n)
        s = fmaf(a.xm[n * J + m], rnd<T>(DF0[(g * J + n) * C + c]), s);
      DF0P[r * C + c] = s;
    } else {
      for (int n = 0; n < J; ++n)
        s = fmaf(a.xm[J * J + n * J + m],
                 rnd<T>(DF1[(g * J + n) * C2 + c - C]), s);
      DF1P[r * C2 + c - C] = s;
    }
  }
  __syncthreads();
  gemm_nt<T>(DF0P, C, R, C, p + o[X0_W], C, C,
             [&](int r, int k, float v) { DZ[r * C + k] = v; });
  gemm_nt<T>(DF1P, C2, R, C2, p + o[X1_W], C2, C,
             [&](int r, int k, float v) { DZ[r * C + k] += v; });
  gemm_tn_acc<T>(Z, C, DF0P, C, R, C, C, PG + o[X0_W], C);
  colsum_acc(DF0P, C, R, C, PG + o[X0_B]);
  gemm_tn_acc<T>(Z, C, DF1P, C2, R, C, C2, PG + o[X1_W], C2);
  colsum_acc(DF1P, C2, R, C2, PG + o[X1_B]);
  __syncthreads();

  // dzpre = dz * dp1; it is both dattn and dgcn
  for (int i = tid; i < R * C; i += NT) {
    const int smp = s0 + i / C / J;
    DZ[i] *= drop(stream_key(a.seed, a.unit, smp, M_DP1), 0, a.path);
  }
  __syncthreads();

  // MGCN backward
  const T* gm = p + o[GCN_M];
  const T* gdiag = p + o[GCN_DIAG];
  const T* goff = p + o[GCN_OFF];
  colsum_acc(DZ, C, R, C, PG + o[GCN_B]);
  for (int i = tid; i < R * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const int g = r / J;
    const int n = r % J;
    const float dh0 = ld(gdiag + n) * DZ[i];
    float dh1 = 0.0f;
    for (int m = 0; m < J; ++m)
      dh1 = fmaf(ld(goff + m * J + n), rnd<T>(DZ[(g * J + m) * C + c]), dh1);
    const float mv = ld(gm + n * C + c);
    TMP[i] = dh0 * G0[i] + dh1 * G1[i];  // dM, per row
    DH0[i] = dh0 * mv;
    DH1[i] = dh1 * mv;
  }
  __syncthreads();
  for (int i = tid; i < J * C; i += NT) {
    float s = 0.0f;
    for (int g = 0; g < ns; ++g) s += TMP[g * J * C + i];
    PG[o[GCN_M] + i] += s;
  }
  for (int i = tid; i < J * J; i += NT) {
    const int n = i / J;
    const int m = i % J;
    float s = 0.0f;
    for (int g = 0; g < ns; ++g) {
      const float* dz = DZ + (g * J + n) * C;
      const float* g1 = G1 + (g * J + m) * C;
      for (int c = 0; c < C; ++c)
        s = fmaf(rnd<T>(dz[c]), rnd<T>(g1[c] * ld(gm + m * C + c)), s);
    }
    PG[o[GCN_OFF] + i] += s;
  }
  for (int n = tid; n < J; n += NT) {
    float s = 0.0f;
    for (int g = 0; g < ns; ++g) {
      const int r = g * J + n;
      for (int c = 0; c < C; ++c)
        s = fmaf(G0[r * C + c] * ld(gm + n * C + c), DZ[r * C + c], s);
    }
    PG[o[GCN_DIAG] + n] += s;
  }
  gemm_nt<T>(DH0, C, R, C, p + o[GCN_W0], C, C,
             [&](int r, int k, float v) { DY[r * C + k] = v; });
  gemm_nt<T>(DH1, C, R, C, p + o[GCN_W1], C, C,
             [&](int r, int k, float v) { DY[r * C + k] += v; });
  gemm_tn_acc<T>(Y, C, DH0, C, R, C, C, PG + o[GCN_W0], C);
  gemm_tn_acc<T>(Y, C, DH1, C, R, C, C, PG + o[GCN_W1], C);
  for (int i = tid; i < R * C; i += NT) {
    const int smp = s0 + i / C / J;
    const int n = i / C % J;
    DATT[i] = DZ[i] * drop(stream_key(a.seed, a.unit, smp, M_PROJ),
                           n * C + i % C, a.proj);
  }
  __syncthreads();

  // projection backward
  gemm_nt<T>(DATT, C, R, C, p + o[PROJ_W], C, C,
             [&](int r, int k, float v) { DA1[r * C + k] = v; });
  gemm_tn_acc<T>(A1, C, DATT, C, R, C, C, PG + o[PROJ_W], C);
  colsum_acc(DATT, C, R, C, PG + o[PROJ_B]);
  __syncthreads();

  // attention backward: ds = p * (dprob - <dprob, p>), dprob = m * (da v)
  for (int task = tid; task < H * R; task += NT) {
    const int h = task / R;
    const int r = task % R;
    const int g = r / J;
    float da[D];
#pragma unroll
    for (int d = 0; d < D; ++d) da[d] = rnd<T>(DA1[r * C + h * D + d]);
    const float* vb = QKV + g * J * C3 + 2 * C + h * D;
    const float* prow = P + r * HJ + h * J;
    const float* mrow = MA + r * HJ + h * J;
    float* dsrow = DS + r * HJ + h * J;
    float dot = 0.0f;
    for (int m = 0; m < J; ++m) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(da[d], rnd<T>(vb[m * C3 + d]), s);
      const float dprob = s * mrow[m];
      dsrow[m] = dprob;
      dot = fmaf(dprob, prow[m], dot);
    }
    for (int m = 0; m < J; ++m) dsrow[m] = prow[m] * (dsrow[m] - dot);
  }
  __syncthreads();
  for (int i = tid; i < H * J * J; i += NT) {
    const int h = i / (J * J);
    const int n = i / J % J;
    const int m = i % J;
    float s = 0.0f;
    for (int g = 0; g < ns; ++g) s += DS[(g * J + n) * HJ + h * J + m];
    PG[o[HOP_BIAS] + i] += s;
  }
  // dq (row as query), dk and dv (row as key)
  for (int task = tid; task < H * R; task += NT) {
    const int h = task / R;
    const int r = task % R;
    const int g = r / J;
    const int n = r % J;
    float dq[D], dk[D], dv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = dk[d] = dv[d] = 0.0f;
    for (int m = 0; m < J; ++m) {
      const int rm = g * J + m;
      const float ds_q = rnd<T>(DS[r * HJ + h * J + m]);   // ds[n, m]
      const float ds_k = rnd<T>(DS[rm * HJ + h * J + n]);  // ds[m, n]
      const float pd = rnd<T>(P[rm * HJ + h * J + n] * MA[rm * HJ + h * J + n]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dq[d] = fmaf(ds_q, rnd<T>(QKV[rm * C3 + C + h * D + d]), dq[d]);
        dk[d] = fmaf(ds_k, rnd<T>(QKV[rm * C3 + h * D + d]), dk[d]);
        dv[d] = fmaf(pd, rnd<T>(DA1[rm * C + h * D + d]), dv[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      DQKV[r * C3 + h * D + d] = dq[d] * scale;
      DQKV[r * C3 + C + h * D + d] = dk[d] * scale;
      DQKV[r * C3 + 2 * C + h * D + d] = dv[d];
    }
  }
  __syncthreads();
  colsum_acc(DQKV, C3, R, C3, PG + o[QKV_B]);
  gemm_tn_acc<T>(Y, C, DQKV, C3, R, C, C3, PG + o[QKV_W], C3);
  gemm_nt<T>(DQKV, C3, R, C3, p + o[QKV_W], C3, C,
             [&](int r, int k, float v) { DY[r * C + k] += v; });
  __syncthreads();
  ln_bwd_rows<C>(DY, C, X, C, R, p + o[N1_W], 1e-5f, STATS,
                 [&](int r, int c, float v) { DX[r * C + c] += v; });
  __syncthreads();
  norm_param_acc(DY, C, X, C, STATS, R, C, PG + o[N1_W], PG + o[N1_B]);
  T* dxo = a.out + (size_t)s0 * J * C;
  for (int i = tid; i < R * C; i += NT) dxo[i] = Num<T>::from_float(DX[i]);
}

template <typename T>
__global__ void __launch_bounds__(NT) gat_block_fwd_kernel(Args<T> a) {
  const int ngroups = (a.B + a.G - 1) / a.G;
  float* S = a.scratch + (size_t)blockIdx.x * FWD_FLOATS;
  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const int s0 = grp * a.G;
    block_fwd(a, S, s0, min(a.G, a.B - s0), true);
    __syncthreads();
  }
}

// Capped at 128 registers (two CTAs per SM): at its natural 184 one CTA
// fit per SM, and the cap measured faster on the H100 despite its spills.
template <typename T>
__global__ void __launch_bounds__(NT, 2) gat_block_bwd_kernel(Args<T> a) {
  const int ngroups = (a.B + a.G - 1) / a.G;
  float* S = a.scratch + (size_t)blockIdx.x * BWD_FLOATS;
  float* PG = a.part + (size_t)blockIdx.x * a.pstride;
  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const int s0 = grp * a.G;
    const int ns = min(a.G, a.B - s0);
    block_fwd(a, S, s0, ns, false);
    block_bwd(a, S, s0, ns, PG);
    __syncthreads();
  }
}

template <typename T>
Args<T> make_args(const void* x, const void* bias, const void* xm,
                  const void* w, const void* offs, int B, int J, int G,
                  unsigned seed, int unit, const unsigned* thr,
                  const float* scl) {
  Args<T> a{};
  a.x = static_cast<const T*>(x);
  a.bias = static_cast<const float*>(bias);
  a.xm = static_cast<const float*>(xm);
  a.w = static_cast<const T*>(w);
  a.offs = static_cast<const int*>(offs);
  a.B = B;
  a.J = J;
  a.G = G;
  a.seed = seed;
  a.unit = unit;
  a.attn = Drop{thr[0], scl[0]};
  a.proj = Drop{thr[1], scl[1]};
  a.mlp = Drop{thr[2], scl[2]};
  a.path = Drop{thr[3], scl[3]};
  return a;
}

}  // namespace gtrain
}  // namespace gator

using gator::gtrain::Args;
using gator::gtrain::make_args;

// Floats of scratch per CTA: the forward's (backward = 0) or the
// backward's (backward = 1).
extern "C" int gat_block_train_scratch(int backward) {
  return (int)(backward ? gator::gtrain::BWD_FLOATS : gator::gtrain::FWD_FLOATS);
}

// dtype: 0 = float32, 1 = bfloat16. thr/scl: (attn, proj, mlp, path) keep
// thresholds and scales. masks (may be null): the export buffer, laid out
// attn [B,H,J,J] | proj [B,J,C] | dp1 [B] | mlp1 [B,J,4C] | mlp2 [B,J,C] |
// dp2 [B]. Returns the cudaError_t of the launch.
extern "C" int gat_block_train_fwd(int dtype, const void* x, const void* bias,
                                   const void* xm, const void* w,
                                   const void* offs, void* out, void* scratch,
                                   void* masks, int B, int J, int G,
                                   int nctas, unsigned seed, int unit,
                                   unsigned t_attn, float s_attn,
                                   unsigned t_proj, float s_proj,
                                   unsigned t_mlp, float s_mlp,
                                   unsigned t_path, float s_path,
                                   void* stream) {
  const unsigned thr[4] = {t_attn, t_proj, t_mlp, t_path};
  const float scl[4] = {s_attn, s_proj, s_mlp, s_path};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    auto a = make_args<float>(x, bias, xm, w, offs, B, J, G, seed, unit, thr,
                              scl);
    a.out = static_cast<float*>(out);
    a.scratch = static_cast<float*>(scratch);
    a.masks = static_cast<float*>(masks);
    gator::gtrain::gat_block_fwd_kernel<float>
        <<<nctas, gator::gtrain::NT, 0, s>>>(a);
  } else {
    auto a = make_args<__nv_bfloat16>(x, bias, xm, w, offs, B, J, G, seed,
                                      unit, thr, scl);
    a.out = static_cast<__nv_bfloat16*>(out);
    a.scratch = static_cast<float*>(scratch);
    a.masks = static_cast<float*>(masks);
    gator::gtrain::gat_block_fwd_kernel<__nv_bfloat16>
        <<<nctas, gator::gtrain::NT, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// The backward kernel, then the reduction of its per-CTA gradient partials
// (part: [nctas, pstride] f32, zeroed by the caller) into grads
// ([ngrad] f32: the packed fields' gradients, then the hop/path bias's).
extern "C" int gat_block_train_bwd(int dtype, const void* x, const void* bias,
                                   const void* xm, const void* w,
                                   const void* offs, const void* gout,
                                   void* dx, void* scratch, void* part,
                                   long long pstride, void* grads, int ngrad,
                                   int B, int J, int G, int nctas,
                                   unsigned seed, int unit, unsigned t_attn,
                                   float s_attn, unsigned t_proj,
                                   float s_proj, unsigned t_mlp, float s_mlp,
                                   unsigned t_path, float s_path,
                                   void* stream) {
  const unsigned thr[4] = {t_attn, t_proj, t_mlp, t_path};
  const float scl[4] = {s_attn, s_proj, s_mlp, s_path};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    auto a = make_args<float>(x, bias, xm, w, offs, B, J, G, seed, unit, thr,
                              scl);
    a.gout = static_cast<const float*>(gout);
    a.out = static_cast<float*>(dx);
    a.scratch = static_cast<float*>(scratch);
    a.part = static_cast<float*>(part);
    a.pstride = pstride;
    gator::gtrain::gat_block_bwd_kernel<float>
        <<<nctas, gator::gtrain::NT, 0, s>>>(a);
  } else {
    auto a = make_args<__nv_bfloat16>(x, bias, xm, w, offs, B, J, G, seed,
                                      unit, thr, scl);
    a.gout = static_cast<const __nv_bfloat16*>(gout);
    a.out = static_cast<__nv_bfloat16*>(dx);
    a.scratch = static_cast<float*>(scratch);
    a.part = static_cast<float*>(part);
    a.pstride = pstride;
    gator::gtrain::gat_block_bwd_kernel<__nv_bfloat16>
        <<<nctas, gator::gtrain::NT, 0, s>>>(a);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return gator::reduce_partials(static_cast<const float*>(part), nctas,
                                pstride, ngrad, static_cast<float*>(grads),
                                s);
}
