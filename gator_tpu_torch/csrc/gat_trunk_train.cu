// K5: one GAT block in training mode, forward and backward kernels.
//
// Replaces gator_tpu/nn/pallas_gat_train.py:530 `gat_trunk_train` (custom
// VJP `gat_block_train:478`; forward `_fwd_kernel:335` / `_block_fwd:140`,
// backward `_bwd_kernel:353` / `_block_bwd:227`). Per block and sample
// (reference: lib/models/GAT.py):
//   y   = LN1(x)
//   z   = DropPath1(ProjDrop(Proj(AttnDrop(softmax(qk/4 + hop/path bias)) v))
//                   + MGCN(y))
//   x1  = x + XFeat(z)
//   out = x1 + DropPath2(MlpDrop(fc2(MlpDrop(gelu(fc1(LN2(x1)))))))
// with dropout drawn in-kernel from the hash of csrc/dropout.cuh, keyed per
// (seed, 256 + block, sample, mask-id, element), so every launch draws the
// same mask whatever its tiling. DropPath is one draw per sample.
//
// At embed width C = 128 or 64, 8 heads (`Width`).
//
// Design. A CTA takes one tile of RT = 32 token rows holding G = 32 / J
// whole samples (one sample at J = 17 or 19), so the three per-sample mixes
// (attention over J keys, MGCN's J x J adjacency, XFeat's hop rings) see a
// sample's rows together; they run as FMA loops. Every dense product
// (qkv, proj, MGCN W0/W1, XFeat x0/x1/back, fc1, fc2 and their transposes)
// runs on the tensor cores through csrc/mma.cuh: bf16 mma.sync with f32
// accumulation, or 3xTF32 in f32. A tile's activations live in shared
// memory (in T where they only meet a product, in f32 where the block keeps
// f32) and in the products' register accumulators; the weights stream
// through a two-slot cp.async ring of [64, 64] panels. The MLP walks its
// 4C hidden units in chunks of 64 (fc1's chunk, then its share of fc2
// into register accumulators), so the hidden layer is never held whole.
// One tile per CTA and a 1-D grid: any batch size (B = 65537 runs).
// Shared memory per CTA in bf16 at C = 128: 78 KB forward, 103 KB
// backward, so two CTAs fit an SM; f32 takes one.
//
// Save, do not recompute. The forward writes, per row, every operand the
// backward reads (`ops`, T: y, q/k/v, a1, g0, g1, z, f0, f1, y2, the MLP
// pre-activation and its dropped GELU; x1 in f32): 4.6 KB a row in bf16
// at C = 128, 40 MB a block at B = 512 and J = 17, written once at the
// card's memory rate. The TPU kernel recomputes the forward in its backward; here that
// would cost a second forward of every tile, several times the bytes.
// The backward (gat_block_bwd) walks its tile back through MLP, LN2,
// XFeat, MGCN, attention and LN1, writes dx and, per row, the cotangent
// operands of every weight gradient to the other columns of `ops`; the
// bias, LayerNorm, MGCN graph and hop/path-bias gradients of the tile go
// to the tile's row of `spart` (each entry written once, nothing zeroed).
// gat_block_wgrad forms the ten weight gradients X^T dY over all B * J rows
// on the tensor cores, in chunks of rows, each chunk's 64-row sums added in
// f32 registers in a fixed order; reduce_partials sums the chunk rows and
// the tile rows in order. No atomics: repeat runs are bit-identical.
//
// What bounds it on the H100: the operations, ~4.8 MFMA per sample and
// block forward (J = 17), 0.09 ms for a stage-2 step's six blocks at
// B = 512 on bf16 tensor cores, and about as long for the bytes the
// launches move (x, out, gout, dx, the saved operands, the weights). The
// forward and the row backward take about 15 and 20 times their bounds
// (tools/profile_train.py times each launch; benchmark/core/counts.py
// counts the work), spread over
// the products' epilogues, the mma, the
// panel copies and the mixes, none dominant: a tile of one sample leaves
// each panel little work between barriers. Deeper rings (three or four
// slots) ran no faster.
#include "mma.cuh"
#include "train_ops.cuh"

namespace gator {
namespace gtrain {

// The widths of a block at embed width C (gator_tpu/models/gat.py: 8
// heads, MLP ratio 4; the XFeat second ring C / 8). The kernels are built
// for C = 128 and C = 64; at C = 64 the head width and the second ring are
// 8 wide, and a product of depth 8 in bf16 takes the mma k-step of 16 with
// the fragments' upper half zeroed (`mma_tile`), adding exact zeros.
template <int C_>
struct Width {
  static constexpr int C = C_;
  static constexpr int D = C / 8;      // head width
  static constexpr int C3 = 3 * C;     // qkv width
  static constexpr int HID = 4 * C;    // MLP hidden
  static constexpr int C2 = C / 8;     // second XFeat ring width
  static_assert(C == 128 || C == 64, "K5 is built for C = 128 and 64");
};

constexpr int H = 8;      // heads
constexpr int JMAX = 32;  // most joints
constexpr int RT = 32;    // token rows per tile
constexpr int NT = 256;   // threads: 8 warps, 2 row tiles x 4 column groups
constexpr int PK = 64;    // a staged weight panel is at most PK x PK
constexpr int HG = 2;     // heads per group in the attention backward
constexpr int LJ = JMAX + 1;  // row stride of the backward's [RT, J] buffers
constexpr int WR = 64;    // rows of ops per gat_block_wgrad chain

// Field order of a block's packed weights; must match BLOCK_PARAM_KEYS in
// gator_tpu_torch/nn/gat_trunk_train.py. HOP_BIAS: the gradient of the
// [H, J, J] hop/path bias.
enum Field {
  N1_W, N1_B, QKV_W, QKV_B, PROJ_W, PROJ_B,
  GCN_W0, GCN_W1, GCN_M, GCN_DIAG, GCN_OFF, GCN_B,
  X0_W, X0_B, X1_W, X1_B, BACK_W0, BACK_W1, BACK_B,
  N2_W, N2_B, FC1_W, FC1_B, FC2_W, FC2_B, HOP_BIAS, NFIELD
};

// Columns of one row of `ops` (T [B * J, W]): the forward's saved
// operands, then the backward's cotangents (`gat_block_train_op_cols`);
// at C = 128: Y 0, QKV 128, A1 512, ..., DQKV 3616, W 4000.
template <int C>
struct Ops {
  using Wd = Width<C>;
  static constexpr int Y = 0, QKV = Y + C, A1 = QKV + Wd::C3, G0 = A1 + C,
                       G1 = G0 + C, Z = G1 + C, F0 = Z + C, F1 = F0 + C,
                       Y2 = F1 + Wd::C2, PRE = Y2 + C, HHD = PRE + Wd::HID,
                       DMM2 = HHD + Wd::HID, DPRE = DMM2 + C,
                       DX1 = DPRE + Wd::HID, DF0P = DX1 + C, DF1P = DF0P + C,
                       DH0M = DF1P + Wd::C2, DH1M = DH0M + C, DATT = DH1M + C,
                       DQKV = DATT + C, W = DQKV + Wd::C3;
};

using tc::ColMajor;
using tc::RowMajor;

// Shared memory, in bytes from the start. Row strides are padded by 16
// bytes (4 f32, 16 / sizeof(T) T) so a warp's fragment loads fall in
// distinct banks. Regions are reused once their phase is over (comments).
template <typename T, int C>
struct Sm {
  using Wd = Width<C>;
  static constexpr int C3 = Wd::C3, C2 = Wd::C2;
  static constexpr int E = 16 / (int)sizeof(T);
  // q/k/v rows (never an ldmatrix operand) are padded by 2 elements only:
  // an odd number of words apart in bf16, so the attention backward's
  // lane-per-key loads fall in distinct banks
  static constexpr int LF = C + 4, LT = C + E, LT3 = C3 + 2, LTP = PK + E,
                       LT2 = C2 + E;
  static constexpr int FB = RT * LF * 4;                // [RT, C] f32
  // DY: [RT, C] f32, or a head group's ds (f32) and probabilities (T)
  static constexpr int DYB = FB > HG * RT * LJ * (4 + (int)sizeof(T))
                                 ? FB
                                 : HG * RT * LJ * (4 + (int)sizeof(T));
  static constexpr int TB = RT * LT * (int)sizeof(T);   // [RT, C] T
  static constexpr int T3B = RT * LT3 * (int)sizeof(T);
  static constexpr int T2B = RT * LT2 * (int)sizeof(T);
  static constexpr int SLOT = PK * LTP;                 // T of a ring slot
  static constexpr int RING = 2 * SLOT * (int)sizeof(T);
  // per-tile table: each sample's stream keys, then the rows' LN stats
  static constexpr int NKEY = 16;
  static constexpr int KEYS = 0, STATS = KEYS + RT * NKEY * 4,
                       BASE = STATS + RT * 8;
  // forward: XS x then x1 (f32); YS y, then z, then y2; QA qkv, then the
  // attention output plus MGCN (f32), then f0p | f1p | f1, then the MLP's
  // chunk of hidden units; AB a1, then M * g1, then f0
  static constexpr int XS = BASE, YS = XS + FB, QA = YS + TB, AB = QA + T3B,
                       RING_F = AB + TB, FWD_BYTES = RING_F + RING;
  // backward: DX dx (f32, to the end); DY dy2, the attention's ds and
  // masked probabilities, then dy (f32); QR dz, M * g1, then q/k/v and
  // dq/dk/dv; U0..U2 the phases' T buffers (see gat_block_bwd)
  static constexpr int DX = BASE, DY = DX + FB, QR = DY + DYB, U0 = QR + T3B,
                       U1 = U0 + TB, U2 = U1 + TB, RING_B = U2 + TB,
                       BWD_BYTES = RING_B + RING;
  static constexpr int MIN_CTAS = sizeof(T) == 2 ? 2 : 1;
  static_assert(FB <= T3B && TB + 2 * T2B <= T3B && RT * LTP <= RT * LT3,
                "QA holds the attention output, f0p | f1p | f1, the chunk");
  static_assert(2 * TB <= T3B && FB <= T3B, "QR holds x1, dz | M g1, x");
  static_assert(2 * T2B <= TB && RT * LTP * (int)sizeof(T) <= TB,
                "U2 holds df1 | df1p, U1 the chunk of dpre");
};

template <typename T>
struct Args {
  const T* x;          // [B, J, C] block input
  const float* bias;   // [H, J, J] hop/path bias
  const float* xm;     // [2, J, J] XFeat hop-ring masks
  const T* w;          // packed weights
  const int* offs;     // field offsets in w
  const int* goffs;    // field offsets in the gradient rows (wpart / spart)
  const T* gout;       // [B, J, C] output cotangent (backward)
  T* out;              // [B, J, C] forward output / backward dx
  T* ops;              // [B * J, O::W] saved operands and cotangents
  float* x1s;          // [B * J, C] x1 (f32), saved by the forward
  float* spart;        // [ntiles, sstride] the tiles' small gradients
  long long sstride;
  float* masks;        // mask export (forward; may be null)
  int B, J, G;
  uint32_t seed;
  int unit;
  int sample0;         // global index of sample 0 (keys the dropout masks)
  Drop attn, proj, mlp, path;
};

// A [rows, cols] block of a weight (row-major, lds apart) to stage.
template <typename T>
struct Pan {
  const T* src;
  int lds, rows, cols;
};

// Stream np weight panels through the two ring slots: panel i + 1 is
// copied while `use(i, slot)` runs on panel i. Every thread calls it; one
// barrier per panel (after which the slot of panel i - 1 is free for panel
// i + 1), one at the end (the ring and the products' outputs are then free
// and visible). Deeper rings (three or four slots) measured no faster.
template <typename T, class PanOf, class Use>
__device__ __forceinline__ void stream(T* ring, int np, PanOf pan, Use use) {
  constexpr int E = 16 / (int)sizeof(T), SLOT = PK * (PK + E);
  auto issue = [&](int i) {
    const Pan<T> p = pan(i);
    tc::stage(ring + (i & 1) * SLOT, p.cols + E, p.src, p.lds, p.rows,
              p.cols);
    tc::cp_async_commit();
  };
  issue(0);
  for (int i = 0; i < np; ++i) {
    tc::cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < np) issue(i + 1);
    use(i, ring + (i & 1) * SLOT);
  }
  __syncthreads();
}

// acc += A[m0:m0+16, :K] @ B[:K, n0:n0+8*NB] on the tensor cores (one
// warp; sums over k in a fixed order). A depth that ends half-way through
// a bf16 step (K = 8, the second XFeat ring at C = 64) zeroes the step's
// depth 8..15 in both fragments: the step adds exact zeros there.
template <typename T, int NB, class FA, class FB>
__device__ __forceinline__ void mma_tile(float (&acc)[NB][4], FA a, FB b,
                                         int m0, int n0, int K) {
  using P = tc::Mma<T>;
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  for (int k0 = 0; k0 < K; k0 += P::KS) {
    typename P::A fa = P::load_a(a, m0, k0);
    const bool half = kBf16 && K - k0 < P::KS;
    if constexpr (kBf16)
      if (half) fa.r[2] = fa.r[3] = 0u;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      typename P::B fb = P::load_b(b, k0, n0 + 8 * j);
      if constexpr (kBf16)
        if (half) fb.r[1] = 0u;
      P::mma(acc[j], fa, fb);
    }
  }
}

// the warp's accumulators to out(row, col, v, v') for columns col, col + 1
// below nlim
template <int NB, class Out>
__device__ __forceinline__ void emit(const float (&acc)[NB][4], int m0,
                                     int n0, Out out, int nlim = 1 << 30) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (n0 + 8 * j >= nlim) continue;
    const int n = n0 + 8 * j + 2 * t;
    out(m0 + g, n, acc[j][0], acc[j][1]);
    out(m0 + g + 8, n, acc[j][2], acc[j][3]);
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
}

// One term of a product: A [RT, k] (T, shared memory, lda apart) times
// B = W [k, N] (trans false) or W^T with W stored [N, k] (trans true), W
// row-major in global memory, ldw apart.
template <typename T>
struct Term {
  const T* a;
  int lda;
  const T* w;
  int ldw, k;
  bool trans;
};

// out(r, n, v, v') = sum over the terms of A @ B, for every row of the
// tile and n < N (N = C / 8 or a multiple of 64), in [64-column] panels; each
// warp owns a [16, 16] block of a panel, its sum over the terms and depth
// in its registers.
template <typename T, int NTERM, class Out>
__device__ void product(T* ring, const Term<T> (&tm)[NTERM], int N,
                        Out out) {
  constexpr int E = 16 / (int)sizeof(T);
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 16;
  const int NW = min(N, PK);
  int per = 0;
#pragma unroll
  for (int t = 0; t < NTERM; ++t) per += (tm[t].k + PK - 1) / PK;
  // panel i -> (column panel, term, depth panel)
  auto where = [&](int i, int& nb, int& t, int& kb) {
    nb = i / per;
    kb = i % per;
    t = 0;
    while (kb >= (tm[t].k + PK - 1) / PK) kb -= (tm[t++].k + PK - 1) / PK;
  };
  float acc[2][4];
  stream<T>(
      ring, (N / NW) * per,
      [&](int i) {
        int nb, t, kb;
        where(i, nb, t, kb);
        const Term<T>& q = tm[t];
        const int kp = min(q.k, PK);
        return q.trans ? Pan<T>{q.w + (size_t)nb * NW * q.ldw + kb * kp,
                                q.ldw, NW, kp}
                       : Pan<T>{q.w + (size_t)kb * kp * q.ldw + nb * NW,
                                q.ldw, kp, NW};
      },
      [&](int i, const T* s) {
        int nb, t, kb;
        where(i, nb, t, kb);
        const Term<T>& q = tm[t];
        const int kp = min(q.k, PK);
        if (i % per == 0) zero(acc);
        if (n0 >= NW) return;
        const RowMajor<T> fa{q.a + kb * kp, q.lda};
        if (q.trans)
          mma_tile<T>(acc, fa, ColMajor<T>{s, kp + E}, m0, n0, kp);
        else
          mma_tile<T>(acc, fa, RowMajor<T>{s, NW + E}, m0, n0, kp);
        if (i % per == per - 1)
          emit(acc, m0, nb * NW + n0, out, nb * NW + NW);
      });
}

template <typename T>
__device__ __forceinline__ Term<T> term(const T* a, int lda, const T* w,
                                        int ldw, int k, bool trans) {
  return Term<T>{a, lda, w, ldw, k, trans};
}

// Column sums over the tile's R rows of a [RT, n] buffer (f32 or T) into
// G[0..n) (a tile's bias gradient; each column one thread, rows in order)
template <typename E>
__device__ __forceinline__ void colsum(const E* buf, int ld, int R, int n,
                                       float* G) {
  for (int c = threadIdx.x; c < n; c += NT) {
    float s = 0.0f;
    for (int r = 0; r < R; ++r) s += Num<E>::to_float(buf[r * ld + c]);
    G[c] = s;
  }
}

// Sums over the tile's rows of dy * xhat and dy (a LayerNorm's weight and
// bias gradients), xhat from X (f32, ldx apart) and the rows' stats
template <int C>
__device__ __forceinline__ void ln_param_sums(const float* DY, int ldy,
                                              const float* X, int ldx,
                                              const float* stats, int R,
                                              float* Gw, float* Gb) {
  for (int c = threadIdx.x; c < C; c += NT) {
    float sw = 0.0f, sb = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float dy = DY[r * ldy + c];
      sw += dy * (X[r * ldx + c] - stats[2 * r]) * stats[2 * r + 1];
      sb += dy;
    }
    Gw[c] = sw;
    Gb[c] = sb;
  }
}

// the tile's stream keys: KEYS[g * NKEY + mid] for its samples
template <typename T, int C>
__device__ __forceinline__ void make_keys(const Args<T>& a, uint32_t* KEYS,
                                          int s0, int ns) {
  for (int i = threadIdx.x; i < ns * 13; i += NT)
    KEYS[(i / 13) * Sm<T, C>::NKEY + i % 13] =
        stream_key(a.seed, a.unit, a.sample0 + s0 + i / 13, i % 13);
}

// One tile's forward: the block output, the saved operands and x1, and
// the exported masks.
template <typename T, int C>
__global__ void __launch_bounds__(NT, Sm<T, C>::MIN_CTAS)
    gat_block_fwd(Args<T> a) {
  using L = Sm<T, C>;
  using O = Ops<C>;
  constexpr int C3 = Width<C>::C3, C2 = Width<C>::C2, HID = Width<C>::HID,
                D = Width<C>::D;
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char sm[];
  const int J = a.J;
  const int s0 = blockIdx.x * a.G;
  const int ns = min(a.G, a.B - s0);
  const int R = ns * J;
  const size_t row0 = (size_t)s0 * J;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  T* ops = a.ops + row0 * O::W;
  uint32_t* KEYS = at<uint32_t>(sm, L::KEYS);
  float* XS = at<float>(sm, L::XS);
  T* YS = at<T>(sm, L::YS);
  T* QKV = at<T>(sm, L::QA);
  float* ZF = at<float>(sm, L::QA);
  T* F0P = at<T>(sm, L::QA);
  T* F1P = at<T>(sm, L::QA + L::TB);
  T* F1 = at<T>(sm, L::QA + L::TB + L::T2B);
  T* HC = at<T>(sm, L::QA);
  T* A1 = at<T>(sm, L::AB);
  T* G1M = at<T>(sm, L::AB);
  T* F0 = at<T>(sm, L::AB);
  T* ring = at<T>(sm, L::RING_F);
  const float scale = rsqrtf((float)D);
  const bool dump = a.masks != nullptr;
  const size_t o_proj = (size_t)a.B * H * J * J;
  const size_t o_dp1 = o_proj + (size_t)a.B * J * C;
  const size_t o_mlp1 = o_dp1 + a.B;
  const size_t o_mlp2 = o_mlp1 + (size_t)a.B * J * HID;
  const size_t o_dp2 = o_mlp2 + (size_t)a.B * J * C;
  auto key = [&](int r, int mid) { return KEYS[(r / J) * L::NKEY + mid]; };
  auto put = [&](int col, int r, int c, float v0, float v1) {
    if (r < R) st2(ops + (size_t)r * O::W + col + c, v0, v1);
  };

  make_keys<T, C>(a, KEYS, s0, ns);
  for (int i = tid; i < RT * C; i += NT) {
    const int r = i / C, c = i % C;
    XS[r * L::LF + c] =
        r < R ? N::to_float(a.x[(row0 + r) * C + c]) : 0.0f;
  }
  __syncthreads();
  layer_norm_rows<C>(XS, L::LF, RT, p + o[N1_W], p + o[N1_B], 1e-5f, false,
                     [&](int r, int c, float v) {
                       YS[r * L::LT + c] = N::from_float(v);
                       if (r < R) ops[(size_t)r * O::W + O::Y + c] = N::from_float(v);
                     });
  __syncthreads();

  // qkv = y @ Wqkv + b, rounded (the products read q, k, v rounded)
  const T* qkv_b = p + o[QKV_B];
  {
    const Term<T> tm[1] = {term(YS, L::LT, p + o[QKV_W], C3, C, false)};
    product<T>(ring, tm, C3, [&](int r, int n, float v0, float v1) {
      const float2 b = ld2(qkv_b + n);
      st2(QKV + r * L::LT3 + n, v0 + b.x, v1 + b.y);
      put(O::QKV, r, n, v0 + b.x, v1 + b.y);
    });
  }

  // attention: one thread per (head, query row); scores recomputed in
  // each of three passes (max, sum, probabilities), none stored
  {
    const int h = tid / RT, r = tid % RT;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.0f;
    if (r < R) {
      const int g = r / J, n = r % J, smp = s0 + g;
      float q[D];
#pragma unroll
      for (int d = 0; d < D; ++d) q[d] = N::to_float(QKV[r * L::LT3 + h * D + d]);
      const T* kb = QKV + g * J * L::LT3 + C + h * D;
      const T* vb = QKV + g * J * L::LT3 + 2 * C + h * D;
      const float* brow = a.bias + (h * J + n) * J;
      auto score = [&](int m) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d)
          s = fmaf(q[d], N::to_float(kb[m * L::LT3 + d]), s);
        return s * scale + brow[m];
      };
      float mx = -CUDART_INF_F;
      for (int m = 0; m < J; ++m) mx = fmaxf(mx, score(m));
      float sum = 0.0f;
      for (int m = 0; m < J; ++m) sum += expf(score(m) - mx);
      const uint32_t kh = key(r, M_ATTN0 + h);
      for (int m = 0; m < J; ++m) {
        const float pr = expf(score(m) - mx) / sum;
        const float mk = drop(kh, n * J + m, a.attn);
        if (dump) a.masks[((size_t)smp * H + h) * J * J + n * J + m] = mk;
        const float pd = rnd<T>(pr * mk);
#pragma unroll
        for (int d = 0; d < D; ++d)
          acc[d] = fmaf(pd, N::to_float(vb[m * L::LT3 + d]), acc[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < D; d += 2) {
      st2(A1 + r * L::LT + h * D + d, acc[d], acc[d + 1]);
      put(O::A1, r, h * D + d, acc[d], acc[d + 1]);
    }
  }
  __syncthreads();

  // ZF = ProjDrop(a1 @ Wproj + b) (f32, over the dead qkv)
  const T* proj_b = p + o[PROJ_B];
  {
    const Term<T> tm[1] = {term(A1, L::LT, p + o[PROJ_W], C, C, false)};
    product<T>(ring, tm, C, [&](int r, int c, float v0, float v1) {
      float m0 = 0.0f, m1 = 0.0f;
      if (r < R) {
        const int n = r % J;
        const uint32_t k = key(r, M_PROJ);
        m0 = drop(k, n * C + c, a.proj);
        m1 = drop(k, n * C + c + 1, a.proj);
        if (dump) {
          const size_t e = o_proj + ((size_t)(s0 + r / J) * J + n) * C + c;
          a.masks[e] = m0;
          a.masks[e + 1] = m1;
        }
      }
      const float2 b = ld2(proj_b + c);
      st2(ZF + r * L::LF + c, (v0 + b.x) * m0, (v1 + b.y) * m1);
    });
  }
  // MGCN: ZF += diag * (M g0) + b, with g0 = y @ W0; G1M = M g1 (rounded,
  // over the dead a1); g0 and g1 saved
  const T* gm = p + o[GCN_M];
  const T* gdiag = p + o[GCN_DIAG];
  const T* goff = p + o[GCN_OFF];
  const T* gb = p + o[GCN_B];
  {
    const Term<T> tm[1] = {term(YS, L::LT, p + o[GCN_W0], C, C, false)};
    product<T>(ring, tm, C, [&](int r, int c, float v0, float v1) {
      if (r >= R) return;
      const int n = r % J;
      const float dg = ld(gdiag + n);
      const float2 m = ld2(gm + n * C + c), b = ld2(gb + c);
      float* z = ZF + r * L::LF + c;
      z[0] += dg * (v0 * m.x) + b.x;
      z[1] += dg * (v1 * m.y) + b.y;
      put(O::G0, r, c, v0, v1);
    });
  }
  {
    const Term<T> tm[1] = {term(YS, L::LT, p + o[GCN_W1], C, C, false)};
    product<T>(ring, tm, C, [&](int r, int c, float v0, float v1) {
      float2 m = make_float2(0.0f, 0.0f);
      if (r < R) m = ld2(gm + (r % J) * C + c);
      st2(G1M + r * L::LT + c, v0 * m.x, v1 * m.y);
      put(O::G1, r, c, v0, v1);
    });
  }
  // z = DropPath1(ZF + adj_off @ (M g1)), rounded into YS (y is dead)
  for (int i = tid; i < RT * C; i += NT) {
    const int r = i / C, c = i % C;
    float z = 0.0f;
    if (r < R) {
      const int g = r / J, n = r % J;
      float t = 0.0f;
      for (int m = 0; m < J; ++m)
        t = fmaf(ld(goff + n * J + m),
                 N::to_float(G1M[(g * J + m) * L::LT + c]), t);
      const float dp = drop(key(r, M_DP1), 0, a.path);
      if (dump && n == 0 && c == 0) a.masks[o_dp1 + s0 + g] = dp;
      z = (ZF[r * L::LF + c] + t) * dp;
      ops[(size_t)r * O::W + O::Z + c] = N::from_float(z);
    }
    YS[r * L::LT + c] = N::from_float(z);
  }
  __syncthreads();

  // XFeat: the ring projections (over the dead ZF), then the per-sample
  // hop-ring sums f0 = m0 f0p (over the dead M g1), f1 = m1 f1p
  const T* x0_b = p + o[X0_B];
  const T* x1_b = p + o[X1_B];
  {
    const Term<T> tm[1] = {term(YS, L::LT, p + o[X0_W], C, C, false)};
    product<T>(ring, tm, C, [&](int r, int c, float v0, float v1) {
      const float2 b = ld2(x0_b + c);
      st2(F0P + r * L::LT + c, v0 + b.x, v1 + b.y);
    });
  }
  {
    const Term<T> tm[1] = {term(YS, L::LT, p + o[X1_W], C2, C, false)};
    product<T>(ring, tm, C2, [&](int r, int c, float v0, float v1) {
      const float2 b = ld2(x1_b + c);
      st2(F1P + r * L::LT2 + c, v0 + b.x, v1 + b.y);
    });
  }
  for (int i = tid; i < RT * (C + C2); i += NT) {
    const int r = i / (C + C2), c = i % (C + C2);
    const int g = r / J, n = r % J;
    const bool ring0 = c < C;
    float s = 0.0f;
    if (r < R) {
      const float* mrow = a.xm + (ring0 ? 0 : J * J) + n * J;
      for (int m = 0; m < J; ++m)
        s = fmaf(mrow[m],
                 ring0 ? N::to_float(F0P[(g * J + m) * L::LT + c])
                       : N::to_float(F1P[(g * J + m) * L::LT2 + c - C]),
                 s);
      ops[(size_t)r * O::W + (ring0 ? O::F0 + c : O::F1 + c - C)] =
          N::from_float(s);
    }
    if (ring0)
      F0[r * L::LT + c] = N::from_float(s);
    else
      F1[r * L::LT2 + c - C] = N::from_float(s);
  }
  __syncthreads();
  // x1 = x + (f0 @ B0 + f1 @ B1 + b), in XS; saved in f32
  const T* back_b = p + o[BACK_B];
  {
    const Term<T> tm[2] = {term(F0, L::LT, p + o[BACK_W0], C, C, false),
                           term(F1, L::LT2, p + o[BACK_W1], C, C2, false)};
    product<T>(ring, tm, C, [&](int r, int c, float v0, float v1) {
      const float2 b = ld2(back_b + c);
      float* x = XS + r * L::LF + c;
      x[0] += v0 + b.x;
      x[1] += v1 + b.y;
      if (r < R) st2(a.x1s + (row0 + r) * C + c, x[0], x[1]);
    });
  }
  layer_norm_rows<C>(XS, L::LF, RT, p + o[N2_W], p + o[N2_B], 1e-5f, false,
                     [&](int r, int c, float v) {
                       YS[r * L::LT + c] = N::from_float(v);
                       if (r < R) ops[(size_t)r * O::W + O::Y2 + c] = N::from_float(v);
                     });
  __syncthreads();

  // MLP in chunks of 64 hidden units: panels fc1[:, chunk] (NQ depth
  // panels), then fc2[chunk, :] (NQ column panels) into acc2
  constexpr int NQ = C / PK;
  const int warp = tid >> 5, m0 = (warp & 1) * 16, n0 = (warp >> 1) * 16;
  const T* fc1_b = p + o[FC1_B];
  const T* fc1 = p + o[FC1_W];
  const T* fc2 = p + o[FC2_W];
  float acc1[2][4], acc2[NQ][2][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q) zero(acc2[q]);
  stream<T>(
      ring, 2 * NQ * (HID / PK),
      [&](int i) {
        const int hc = i / (2 * NQ), q = i % (2 * NQ);
        return q < NQ
                   ? Pan<T>{fc1 + (size_t)q * PK * HID + hc * PK, HID, PK, PK}
                   : Pan<T>{fc2 + (size_t)hc * PK * C + (q - NQ) * PK, C, PK,
                            PK};
      },
      [&](int i, const T* s) {
        const int hc = i / (2 * NQ), q = i % (2 * NQ);
        if (q < NQ) {
          if (q == 0) zero(acc1);
          mma_tile<T>(acc1, RowMajor<T>{YS + q * PK, L::LT},
                      RowMajor<T>{s, L::LTP}, m0, n0, PK);
          if (q < NQ - 1) return;
          emit(acc1, m0, n0, [&](int r, int cc, float v0, float v1) {
            const int c = hc * PK + cc;
            const float2 b = ld2(fc1_b + c);
            const float pre0 = v0 + b.x, pre1 = v1 + b.y;
            float m0k = 0.0f, m1k = 0.0f;
            if (r < R) {
              const uint32_t k = key(r, M_MLP1);
              const int n = r % J;
              m0k = drop(k, n * HID + c, a.mlp);
              m1k = drop(k, n * HID + c + 1, a.mlp);
              if (dump) {
                const size_t e =
                    o_mlp1 + ((size_t)(s0 + r / J) * J + n) * HID + c;
                a.masks[e] = m0k;
                a.masks[e + 1] = m1k;
              }
            }
            const float h0 = gelu_exact(pre0) * m0k,
                        h1 = gelu_exact(pre1) * m1k;
            st2(HC + r * L::LTP + cc, h0, h1);
            put(O::PRE, r, c, pre0, pre1);
            put(O::HHD, r, c, h0, h1);
          });
        } else {
          mma_tile<T>(acc2[q - NQ], RowMajor<T>{HC, L::LTP},
                      RowMajor<T>{s, L::LTP}, m0, n0, PK);
        }
      });
  // out = x1 + DropPath2(MlpDrop(hhd @ fc2 + b))
  const T* fc2_b = p + o[FC2_B];
  for (int half = 0; half < NQ; ++half)
    emit(acc2[half], m0, half * PK + n0,
         [&](int r, int c, float v0, float v1) {
           if (r >= R) return;
           const int n = r % J, smp = s0 + r / J;
           const uint32_t k = key(r, M_MLP2);
           const float mk0 = drop(k, n * C + c, a.mlp),
                       mk1 = drop(k, n * C + c + 1, a.mlp);
           const float dp = drop(key(r, M_DP2), 0, a.path);
           if (dump) {
             const size_t e = o_mlp2 + ((size_t)smp * J + n) * C + c;
             a.masks[e] = mk0;
             a.masks[e + 1] = mk1;
             if (n == 0 && c == 0) a.masks[o_dp2 + smp] = dp;
           }
           const float2 b = ld2(fc2_b + c);
           const float* x1 = XS + r * L::LF + c;
           st2(a.out + (row0 + r) * C + c, x1[0] + (v0 + b.x) * mk0 * dp,
               x1[1] + (v1 + b.y) * mk1 * dp);
         });
}

// One tile's backward (gator_tpu/nn/pallas_gat_train.py `_block_bwd:227`)
// from the saved operands: dx, the cotangent operands of the weight
// gradients (to ops) and the tile's small gradients (to its spart row).
template <typename T, int C>
__global__ void __launch_bounds__(NT, Sm<T, C>::MIN_CTAS)
    gat_block_bwd(Args<T> a) {
  using L = Sm<T, C>;
  using O = Ops<C>;
  constexpr int C3 = Width<C>::C3, C2 = Width<C>::C2, HID = Width<C>::HID,
                D = Width<C>::D;
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char sm[];
  const int J = a.J;
  const int s0 = blockIdx.x * a.G;
  const int ns = min(a.G, a.B - s0);
  const int R = ns * J;
  const size_t row0 = (size_t)s0 * J;
  const int tid = threadIdx.x;
  const T* p = a.w;
  const int* o = a.offs;
  const int* go = a.goffs;
  T* ops = a.ops + row0 * O::W;
  float* SG = a.spart + (size_t)blockIdx.x * a.sstride;
  uint32_t* KEYS = at<uint32_t>(sm, L::KEYS);
  float* STATS = at<float>(sm, L::STATS);
  float* DX = at<float>(sm, L::DX);
  float* DY = at<float>(sm, L::DY);
  float* DS = at<float>(sm, L::DY);                      // [HG][RT][LJ]
  T* PD = at<T>(sm, L::DY + HG * RT * LJ * 4);          // [HG][RT][LJ]
  T* DZT = at<T>(sm, L::QR);
  T* G1M = at<T>(sm, L::QR + L::TB);
  T* QKV = at<T>(sm, L::QR);
  T* DMM2 = at<T>(sm, L::U0);
  T* DPC = at<T>(sm, L::U1);
  T* DX1T = at<T>(sm, L::U0);
  T* DF0P = at<T>(sm, L::U0);
  T* DF0 = at<T>(sm, L::U1);
  T* DF1 = at<T>(sm, L::U2);
  T* DF1P = at<T>(sm, L::U2 + L::T2B);
  T* DATT = at<T>(sm, L::U1);
  T* DA1 = at<T>(sm, L::U2);
  T* DH0M = at<T>(sm, L::U0);
  T* DH1M = at<T>(sm, L::U1);
  T* ring = at<T>(sm, L::RING_B);
  const float scale = rsqrtf((float)D);
  auto key = [&](int r, int mid) { return KEYS[(r / J) * L::NKEY + mid]; };
  auto opv = [&](int r, int col) { return N::to_float(ops[(size_t)r * O::W + col]); };
  auto put = [&](int col, int r, int c, float v0, float v1) {
    if (r < R) st2(ops + (size_t)r * O::W + col + c, v0, v1);
  };

  make_keys<T, C>(a, KEYS, s0, ns);
  __syncthreads();
  // out = x1 + dp2 * m2 * mm2: dx1 = g, dmm2 = g * dp2 * m2
  for (int i = tid; i < RT * C; i += NT) {
    const int r = i / C, c = i % C;
    float go_ = 0.0f, d = 0.0f;
    if (r < R) {
      go_ = N::to_float(a.gout[(row0 + r) * C + c]);
      d = go_ * drop(key(r, M_DP2), 0, a.path) *
          drop(key(r, M_MLP2), (r % J) * C + c, a.mlp);
      ops[(size_t)r * O::W + O::DMM2 + c] = N::from_float(d);
    }
    DX[r * L::LF + c] = go_;
    DMM2[r * L::LT + c] = N::from_float(d);
  }
  __syncthreads();
  colsum(DMM2, L::LT, R, C, SG + go[FC2_B]);

  // MLP in chunks of 64 hidden units: dpre = (dmm2 fc2^T) * m1 * gelu'(pre)
  // (fc2's rows of the chunk, NQ depth panels), then its share of
  // dy2 = dpre fc1^T (fc1's columns of the chunk, NQ column panels)
  constexpr int NQ = C / PK;
  const int warp = tid >> 5, m0 = (warp & 1) * 16, n0 = (warp >> 1) * 16;
  const T* fc1 = p + o[FC1_W];
  const T* fc2 = p + o[FC2_W];
  float acc1[2][4], acc2[NQ][2][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q) zero(acc2[q]);
  stream<T>(
      ring, 2 * NQ * (HID / PK),
      [&](int i) {
        const int hc = i / (2 * NQ), q = i % (2 * NQ);
        return q < NQ
                   ? Pan<T>{fc2 + (size_t)hc * PK * C + q * PK, C, PK, PK}
                   : Pan<T>{fc1 + (size_t)(q - NQ) * PK * HID + hc * PK, HID,
                            PK, PK};
      },
      [&](int i, const T* s) {
        const int hc = i / (2 * NQ), q = i % (2 * NQ);
        if (q < NQ) {
          if (q == 0) zero(acc1);
          mma_tile<T>(acc1, RowMajor<T>{DMM2 + q * PK, L::LT},
                      ColMajor<T>{s, L::LTP}, m0, n0, PK);
          if (q < NQ - 1) return;
          emit(acc1, m0, n0, [&](int r, int cc, float v0, float v1) {
            const int c = hc * PK + cc;
            float d0 = 0.0f, d1 = 0.0f;
            if (r < R) {
              const uint32_t k = key(r, M_MLP1);
              const int n = r % J;
              d0 = v0 * drop(k, n * HID + c, a.mlp) *
                   gelu_grad(opv(r, O::PRE + c));
              d1 = v1 * drop(k, n * HID + c + 1, a.mlp) *
                   gelu_grad(opv(r, O::PRE + c + 1));
            }
            st2(DPC + r * L::LTP + cc, d0, d1);
            put(O::DPRE, r, c, d0, d1);
          });
        } else {
          if (q == NQ) colsum(DPC, L::LTP, R, PK, SG + go[FC1_B] + hc * PK);
          mma_tile<T>(acc2[q - NQ], RowMajor<T>{DPC, L::LTP},
                      ColMajor<T>{s, L::LTP}, m0, n0, PK);
        }
      });
  for (int half = 0; half < NQ; ++half)
    emit(acc2[half], m0, half * PK + n0,
         [&](int r, int c, float v0, float v1) {
           st2(DY + r * L::LF + c, v0, v1);
         });
  __syncthreads();
  // LN2: dx1 = g + LN2'(dy2), from the saved x1 (staged in QR)
  float* X1 = at<float>(sm, L::QR);
  for (int i = tid; i < R * C / 4; i += NT) {
    const int r = i / (C / 4), c = i % (C / 4) * 4;
    *reinterpret_cast<float4*>(X1 + r * L::LF + c) =
        *reinterpret_cast<const float4*>(a.x1s + (row0 + r) * C + c);
  }
  __syncthreads();
  ln_bwd_rows<C>(DY, L::LF, X1, L::LF, R, p + o[N2_W], 1e-5f, STATS,
                 [&](int r, int c, float v) { DX[r * L::LF + c] += v; });
  __syncthreads();
  ln_param_sums<C>(DY, L::LF, X1, L::LF, STATS, R, SG + go[N2_W], SG + go[N2_B]);
  for (int i = tid; i < RT * C; i += NT) {
    const int r = i / C, c = i % C;
    const float v = DX[r * L::LF + c];
    DX1T[r * L::LT + c] = N::from_float(v);
    if (r < R) ops[(size_t)r * O::W + O::DX1 + c] = N::from_float(v);
  }
  __syncthreads();
  colsum(DX1T, L::LT, R, C, SG + go[BACK_B]);

  // XFeat: df0 = dx1 B0^T, df1 = dx1 B1^T (rounded); the per-sample ring
  // transposes df0p = m0^T df0, df1p = m1^T df1
  {
    const Term<T> tm[1] = {term(DX1T, L::LT, p + o[BACK_W0], C, C, true)};
    product<T>(ring, tm, C, [&](int r, int c, float v0, float v1) {
      st2(DF0 + r * L::LT + c, v0, v1);
    });
  }
  {
    const Term<T> tm[1] = {term(DX1T, L::LT, p + o[BACK_W1], C, C, true)};
    product<T>(ring, tm, C2, [&](int r, int c, float v0, float v1) {
      st2(DF1 + r * L::LT2 + c, v0, v1);
    });
  }
  for (int i = tid; i < RT * (C + C2); i += NT) {
    const int r = i / (C + C2), c = i % (C + C2);
    const int g = r / J, m = r % J;
    const bool ring0 = c < C;
    float s = 0.0f;
    if (r < R) {
      const float* mcol = a.xm + (ring0 ? 0 : J * J) + m;
      for (int n = 0; n < J; ++n)
        s = fmaf(mcol[n * J],
                 ring0 ? N::to_float(DF0[(g * J + n) * L::LT + c])
                       : N::to_float(DF1[(g * J + n) * L::LT2 + c - C]),
                 s);
      ops[(size_t)r * O::W + (ring0 ? O::DF0P + c : O::DF1P + c - C)] =
          N::from_float(s);
    }
    if (ring0)
      DF0P[r * L::LT + c] = N::from_float(s);
    else
      DF1P[r * L::LT2 + c - C] = N::from_float(s);
  }
  __syncthreads();
  colsum(DF0P, L::LT, R, C, SG + go[X0_B]);
  colsum(DF1P, L::LT2, R, C2, SG + go[X1_B]);
  // dz = df0p X0^T + df1p X1^T; dzpre = dz * dp1 (rounded, in QR) is both
  // dgcn and, times the projection mask, dattn
  {
    const Term<T> tm[2] = {term(DF0P, L::LT, p + o[X0_W], C, C, true),
                           term(DF1P, L::LT2, p + o[X1_W], C2, C2, true)};
    product<T>(ring, tm, C, [&](int r, int c, float v0, float v1) {
      float z0 = 0.0f, z1 = 0.0f, t0 = 0.0f, t1 = 0.0f;
      if (r < R) {
        const float dp = drop(key(r, M_DP1), 0, a.path);
        const uint32_t k = key(r, M_PROJ);
        const int n = r % J;
        z0 = rnd<T>(v0 * dp);
        z1 = rnd<T>(v1 * dp);
        t0 = z0 * drop(k, n * C + c, a.proj);
        t1 = z1 * drop(k, n * C + c + 1, a.proj);
      }
      st2(DZT + r * L::LT + c, z0, z1);
      st2(DATT + r * L::LT + c, t0, t1);
      put(O::DATT, r, c, t0, t1);
    });
  }
  colsum(DZT, L::LT, R, C, SG + go[GCN_B]);
  colsum(DATT, L::LT, R, C, SG + go[PROJ_B]);
  // da1 = dattn Wproj^T
  {
    const Term<T> tm[1] = {term(DATT, L::LT, p + o[PROJ_W], C, C, true)};
    product<T>(ring, tm, C, [&](int r, int c, float v0, float v1) {
      st2(DA1 + r * L::LT + c, v0, v1);
    });
  }

  // MGCN: dh0 = diag * dz, dh1 = adj_off^T dz (per sample); M's gradient
  // dh0 g0 + dh1 g1, summed over the tile's samples; dh0 M and dh1 M
  // (rounded) are the cotangents of W0 and W1's products
  const T* gm = p + o[GCN_M];
  const T* gdiag = p + o[GCN_DIAG];
  const T* goff = p + o[GCN_OFF];
  for (int i = tid; i < RT * C; i += NT) {
    const int r = i / C, c = i % C;
    G1M[r * L::LT + c] =
        N::from_float(r < R ? opv(r, O::G1 + c) * ld(gm + (r % J) * C + c)
                            : 0.0f);
  }
  for (int i = R * C + tid; i < RT * C; i += NT) {
    DH0M[(i / C) * L::LT + i % C] = N::from_float(0.0f);
    DH1M[(i / C) * L::LT + i % C] = N::from_float(0.0f);
  }
  for (int i = tid; i < J * C; i += NT) {
    const int n = i / C, c = i % C;
    const float mv = ld(gm + n * C + c);
    const float dg = ld(gdiag + n);
    float dmv = 0.0f;
    for (int g = 0; g < ns; ++g) {
      const int r = g * J + n;
      const float dz = N::to_float(DZT[r * L::LT + c]);
      float dh1 = 0.0f;
      for (int m = 0; m < J; ++m)
        dh1 = fmaf(ld(goff + m * J + n),
                   N::to_float(DZT[(g * J + m) * L::LT + c]), dh1);
      const float dh0 = dg * dz;
      dmv += dh0 * opv(r, O::G0 + c) + dh1 * opv(r, O::G1 + c);
      const T h0 = N::from_float(dh0 * mv), h1 = N::from_float(dh1 * mv);
      DH0M[r * L::LT + c] = h0;
      DH1M[r * L::LT + c] = h1;
      ops[(size_t)r * O::W + O::DH0M + c] = h0;
      ops[(size_t)r * O::W + O::DH1M + c] = h1;
    }
    SG[go[GCN_M] + i] = dmv;
  }
  __syncthreads();
  // the diagonal's gradient: one warp per joint; the off-diagonal part's:
  // one thread per (n, m), dz[n] . (M g1)[m] over the tile's samples
  {
    const int lane = tid & 31;
    for (int n = warp; n < J; n += NT / 32) {
      float s = 0.0f;
      for (int g = 0; g < ns; ++g) {
        const int r = g * J + n;
        for (int c = lane; c < C; c += 32)
          s = fmaf(opv(r, O::G0 + c) * ld(gm + n * C + c),
                   N::to_float(DZT[r * L::LT + c]), s);
      }
      s = warp_sum(s);
      if (lane == 0) SG[go[GCN_DIAG] + n] = s;
    }
  }
  for (int i = tid; i < J * J; i += NT) {
    const int n = i / J, m = i % J;
    float s = 0.0f;
    for (int g = 0; g < ns; ++g) {
      const T* dz = DZT + (g * J + n) * L::LT;
      const T* hm = G1M + (g * J + m) * L::LT;
      for (int c = 0; c < C; ++c)
        s = fmaf(N::to_float(dz[c]), N::to_float(hm[c]), s);
    }
    SG[go[GCN_OFF] + i] = s;
  }
  __syncthreads();

  // attention: q, k, v again (over dz and M g1), then per group of HG
  // heads: ds = p * (m * (da v^T) - <m * (da v^T), p>) with p recomputed
  // (one warp per (head, query row), lane = key), then dq, dk, dv (one
  // thread per (head, row, which)) written over q, k, v of those heads
  for (int i = tid; i < RT * C3 / 2; i += NT) {
    const int r = i / (C3 / 2), c = i % (C3 / 2) * 2;
    const float2 v = r < R ? make_float2(opv(r, O::QKV + c), opv(r, O::QKV + c + 1))
                           : make_float2(0.0f, 0.0f);
    st2(QKV + r * L::LT3 + c, v.x, v.y);
  }
  __syncthreads();
  const int lane = tid & 31;
  for (int h0 = 0; h0 < H; h0 += HG) {
    for (int pr = warp; pr < HG * RT; pr += NT / 32) {
      const int hl = pr / RT, r = pr % RT, h = h0 + hl;
      if (r >= R) continue;
      const int g = r / J, n = r % J, m = lane;
      const bool on = m < J;
      const int km = g * J + (on ? m : 0);
      float s = 0.0f, dpd = 0.0f;
#pragma unroll
      for (int d = 0; d < D; d += 2) {
        const float2 q = ld2(QKV + r * L::LT3 + h * D + d),
                     k = ld2(QKV + km * L::LT3 + C + h * D + d),
                     da = ld2(DA1 + r * L::LT + h * D + d),
                     v = ld2(QKV + km * L::LT3 + 2 * C + h * D + d);
        s = fmaf(q.y, k.y, fmaf(q.x, k.x, s));
        dpd = fmaf(da.y, v.y, fmaf(da.x, v.x, dpd));
      }
      s = on ? s * scale + a.bias[(h * J + n) * J + m] : -CUDART_INF_F;
      float mx = s;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float e = on ? expf(s - mx) : 0.0f;
      const float pr_ = e / warp_sum(e);
      const float mk = on ? drop(key(r, M_ATTN0 + h), n * J + m, a.attn) : 0.0f;
      const float dprob = dpd * mk;
      const float dot = warp_sum(dprob * pr_);
      if (on) {
        DS[(hl * RT + r) * LJ + m] = pr_ * (dprob - dot);
        PD[(hl * RT + r) * LJ + m] = N::from_float(pr_ * mk);
      }
    }
    __syncthreads();
    // the hop/path bias's gradient: ds summed over the tile's samples
    for (int i = tid; i < HG * J * J; i += NT) {
      const int hl = i / (J * J), n = i / J % J, m = i % J;
      float s = 0.0f;
      for (int g = 0; g < ns; ++g) s += DS[(hl * RT + g * J + n) * LJ + m];
      SG[go[HOP_BIAS] + ((h0 + hl) * J + n) * J + m] = s;
    }
    float res[D];
    const int which = tid / (HG * RT), hl = tid / RT % HG, r = tid % RT;
    const int h = h0 + hl;
    const bool mine = which < 3 && r < R;
    if (mine) {
      const int g = r / J, n = r % J;
#pragma unroll
      for (int d = 0; d < D; ++d) res[d] = 0.0f;
      for (int m = 0; m < J; ++m) {
        const int rm = g * J + m;
        float wgt;
        const T* src;
        if (which == 0) {         // dq[n] = sum_m ds[n, m] k[m]
          wgt = rnd<T>(DS[(hl * RT + r) * LJ + m]);
          src = QKV + rm * L::LT3 + C + h * D;
        } else if (which == 1) {  // dk[n] = sum_m ds[m, n] q[m]
          wgt = rnd<T>(DS[(hl * RT + rm) * LJ + n]);
          src = QKV + rm * L::LT3 + h * D;
        } else {                  // dv[n] = sum_m pd[m, n] da[m]
          wgt = N::to_float(PD[(hl * RT + rm) * LJ + n]);
          src = DA1 + rm * L::LT + h * D;
        }
#pragma unroll
        for (int d = 0; d < D; ++d)
          res[d] = fmaf(wgt, N::to_float(src[d]), res[d]);
      }
      if (which < 2)
#pragma unroll
        for (int d = 0; d < D; ++d) res[d] *= scale;
    }
    __syncthreads();
    if (mine)
#pragma unroll
      for (int d = 0; d < D; d += 2)
        st2(QKV + r * L::LT3 + which * C + h * D + d, res[d], res[d + 1]);
    __syncthreads();
  }
  for (int i = tid; i < R * C3 / 2; i += NT) {
    const int r = i / (C3 / 2), c = i % (C3 / 2) * 2;
    const float2 v = ld2(QKV + r * L::LT3 + c);
    st2(ops + (size_t)r * O::W + O::DQKV + c, v.x, v.y);
  }
  colsum(QKV, L::LT3, R, C3, SG + go[QKV_B]);

  // dy = dqkv Wqkv^T + (dh0 M) W0^T + (dh1 M) W1^T, then LN1
  {
    const Term<T> tm[3] = {term(QKV, L::LT3, p + o[QKV_W], C3, C3, true),
                           term(DH0M, L::LT, p + o[GCN_W0], C, C, true),
                           term(DH1M, L::LT, p + o[GCN_W1], C, C, true)};
    product<T>(ring, tm, C, [&](int r, int c, float v0, float v1) {
      st2(DY + r * L::LF + c, v0, v1);
    });
  }
  // x in f32 over the dead dqkv, for LN1's backward
  float* XF = at<float>(sm, L::QR);
  for (int i = tid; i < RT * C; i += NT) {
    const int r = i / C, c = i % C;
    XF[r * L::LF + c] = r < R ? N::to_float(a.x[(row0 + r) * C + c]) : 0.0f;
  }
  __syncthreads();
  ln_bwd_rows<C>(DY, L::LF, XF, L::LF, R, p + o[N1_W], 1e-5f, STATS,
                 [&](int r, int c, float v) {
                   a.out[(row0 + r) * C + c] =
                       N::from_float(DX[r * L::LF + c] + v);
                 });
  __syncthreads();
  ln_param_sums<C>(DY, L::LF, XF, L::LF, STATS, R, SG + go[N1_W], SG + go[N1_B]);
}

// gat_block_wgrad's products: G[k][n] = sum_r ops[r][ca + k] * ops[r][cb + n]
// for k < ka, n < nb, a tile of field `field` at element g0 of its
// gradient, rows ldg apart. A C / 8-wide operand is read as 64 columns
// (the rest of the 64 come along from the row) and only its valid part is
// written.
struct WJob {
  int ca, cb, field, g0, ldg, ka, nb;
};

// the jobs at embed width C: KC and KH 64-wide blocks of C and of the MLP
// hidden width; 68 at C = 128, 18 at C = 64
template <int C>
struct WJobs {
  static constexpr int KC = C / 64, KH = 4 * C / 64;
  static constexpr int N = 3 * KC * KC + 4 * KC * KC + KC + KC * KC + KC +
                           2 * KC * KH;
};

template <int C>
__device__ __forceinline__ WJob wjob(int j) {
  using O = Ops<C>;
  constexpr int KC = WJobs<C>::KC, KH = WJobs<C>::KH, C3 = Width<C>::C3,
                C2 = Width<C>::C2, HID = Width<C>::HID;
  if (j < 3 * KC * KC)  // qkv_w [C, 3C]: y x dqkv
    return {O::Y + 64 * (j / (3 * KC)), O::DQKV + 64 * (j % (3 * KC)), QKV_W,
            64 * (j / (3 * KC)) * C3 + 64 * (j % (3 * KC)), C3, 64, 64};
  j -= 3 * KC * KC;
  if (j < 4 * KC * KC) {  // [C, C]: proj_w, gcn_w0, gcn_w1, x0_w
    const int f = j / (KC * KC), i = j % (KC * KC) / KC, k = j % KC;
    const int ca[4] = {O::A1, O::Y, O::Y, O::Z};
    const int cb[4] = {O::DATT, O::DH0M, O::DH1M, O::DF0P};
    const int fd[4] = {PROJ_W, GCN_W0, GCN_W1, X0_W};
    return {ca[f] + 64 * i, cb[f] + 64 * k, fd[f], 64 * i * C + 64 * k, C,
            64, 64};
  }
  j -= 4 * KC * KC;
  if (j < KC)  // x1_w [C, C / 8]: z x df1p
    return {O::Z + 64 * j, O::DF1P, X1_W, 64 * j * C2, C2, 64, C2};
  j -= KC;
  if (j < KC * KC)  // back_w0 [C, C]: f0 x dx1
    return {O::F0 + 64 * (j / KC), O::DX1 + 64 * (j % KC), BACK_W0,
            64 * (j / KC) * C + 64 * (j % KC), C, 64, 64};
  j -= KC * KC;
  if (j < KC)  // back_w1 [C / 8, C]: f1 x dx1
    return {O::F1, O::DX1 + 64 * j, BACK_W1, 64 * j, C, C2, 64};
  j -= KC;
  if (j < KC * KH)  // fc1_w [C, 4C]: y2 x dpre
    return {O::Y2 + 64 * (j / KH), O::DPRE + 64 * (j % KH), FC1_W,
            64 * (j / KH) * HID + 64 * (j % KH), HID, 64, 64};
  j -= KC * KH;  // fc2_w [4C, C]: hhd x dmm2
  return {O::HHD + 64 * (j / KC), O::DMM2 + 64 * (j % KC), FC2_W,
          64 * (j / KC) * C + 64 * (j % KC), C, 64, 64};
}

// One CTA per (weight tile, chunk of `per` rows): the chunk's rows staged
// through shared memory in a two-deep cp.async ring, each 64 rows' product
// on the tensor cores, the running sum in f32 registers (each chain added
// rounded, in a fixed order); the tile written to the chunk's row of
// `part` (every element of every weight field once per chunk).
template <typename T, int C>
__global__ void __launch_bounds__(NT) gat_block_wgrad(
    const T* __restrict__ ops, const int* __restrict__ goffs, float* part,
    long long pstride, int R, int per) {
  using O = Ops<C>;
  constexpr int LD = 64 + 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char sm[];
  T* As = reinterpret_cast<T*>(sm);  // [2][WR][LD]
  T* Bs = As + 2 * WR * LD;
  const WJob job = wjob<C>(blockIdx.x);
  const int rb = blockIdx.y * per, re = min(R, rb + per);
  const int nchunk = re > rb ? (re - rb + WR - 1) / WR : 0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  auto fetch = [&](int buf, int c) {
    const int r = rb + c * WR, n = min(WR, re - r);
    T* A = As + buf * WR * LD;
    T* B = Bs + buf * WR * LD;
    tc::stage(A, LD, ops + (size_t)r * O::W + job.ca, O::W, n, 64);
    tc::stage(B, LD, ops + (size_t)r * O::W + job.cb, O::W, n, 64);
    for (int i = threadIdx.x; i < (WR - n) * 64; i += NT) {
      A[(n + i / 64) * LD + i % 64] = Num<T>::from_float(0.0f);
      B[(n + i / 64) * LD + i % 64] = Num<T>::from_float(0.0f);
    }
    tc::cp_async_commit();
  };
  float tot[4][4];
  zero(tot);
  if (nchunk > 0) fetch(0, 0);
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) {
      fetch((c + 1) & 1, c + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    float acc[4][4];
    zero(acc);
    mma_tile<T>(acc, ColMajor<T>{As + (c & 1) * WR * LD, LD},
                RowMajor<T>{Bs + (c & 1) * WR * LD, LD}, m0, n0, WR);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[j][i] += acc[j][i];
    __syncthreads();
  }
  float* G = part + (size_t)blockIdx.y * pstride + goffs[job.field] + job.g0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= job.nb) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = m0 + g + 8 * hh;
      if (k >= job.ka) continue;
      G[k * job.ldg + n] = tot[j][2 * hh];
      G[k * job.ldg + n + 1] = tot[j][2 * hh + 1];
    }
  }
}

template <typename T>
Args<T> make_args(const void* x, const void* bias, const void* xm,
                  const void* w, const void* offs, void* ops, void* x1s,
                  int B, int J, int G, unsigned seed, int unit,
                  int sample0, const unsigned* thr, const float* scl) {
  Args<T> a{};
  a.x = static_cast<const T*>(x);
  a.bias = static_cast<const float*>(bias);
  a.xm = static_cast<const float*>(xm);
  a.w = static_cast<const T*>(w);
  a.offs = static_cast<const int*>(offs);
  a.ops = static_cast<T*>(ops);
  a.x1s = static_cast<float*>(x1s);
  a.B = B;
  a.J = J;
  a.G = G;
  a.seed = seed;
  a.unit = unit;
  a.sample0 = sample0;
  a.attn = Drop{thr[0], scl[0]};
  a.proj = Drop{thr[1], scl[1]};
  a.mlp = Drop{thr[2], scl[2]};
  a.path = Drop{thr[3], scl[3]};
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

template <typename T>
int wgrad_smem() {
  return 4 * WR * (64 + 16 / (int)sizeof(T)) * (int)sizeof(T);
}

template <typename T, int C>
int run_bwd(Args<T> a, int ntiles, float* wpart, long long wstride,
            int nc_w, int wper, float* sgrads, float* wgrads,
            cudaStream_t s) {
  int err = launch_smem(gat_block_bwd<T, C>, dim3(ntiles),
                        Sm<T, C>::BWD_BYTES, s, a);
  if (err != 0) return err;
  err = launch_smem(gat_block_wgrad<T, C>, dim3(WJobs<C>::N, nc_w),
                    wgrad_smem<T>(), s, (const T*)a.ops, a.goffs, wpart,
                    wstride, a.B * a.J, wper);
  if (err != 0) return err;
  err = reduce_partials(wpart, nc_w, wstride, (int)wstride, wgrads, s);
  if (err != 0) return err;
  return reduce_partials(a.spart, ntiles, a.sstride, (int)a.sstride, sgrads,
                         s);
}

// what: 0 registers a thread, 1 CTAs resident per SM, 2 shared-memory bytes
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

// the instance for (dtype, c): f(Tag<T, C>{}); -1 for a width not built
template <typename T, int C>
struct Tag {
  using Type = T;
  static constexpr int kC = C;
};

template <class F>
int dispatch(int dtype, int c, F f) {
  if (c == 128)
    return dtype == 0 ? f(Tag<float, 128>{}) : f(Tag<__nv_bfloat16, 128>{});
  if (c == 64)
    return dtype == 0 ? f(Tag<float, 64>{}) : f(Tag<__nv_bfloat16, 64>{});
  return -1;
}

}  // namespace gtrain
}  // namespace gator

using gator::gtrain::Args;
using gator::gtrain::make_args;

// Columns of a row of the saved operands and cotangents (`ops`) at embed
// width c (-1 for a width the kernels are not built for).
extern "C" int gat_block_train_op_cols(int c) {
  return gator::gtrain::dispatch(0, c, [](auto tag) {
    return gator::gtrain::Ops<decltype(tag)::kC>::W;
  });
}

// Registers a thread (what = 0), CTAs resident per SM (1) or shared-memory
// bytes (2) of gat_block_fwd (kernel = 0), gat_block_bwd (1) or
// gat_block_wgrad (2) for dtype (0 = float32, 1 = bfloat16) and embed width
// c; -1 if the query fails.
extern "C" int gat_block_train_info(int dtype, int c, int kernel, int what) {
  using namespace gator::gtrain;
  return dispatch(dtype, c, [&](auto tag) {
    using T = typename decltype(tag)::Type;
    constexpr int C = decltype(tag)::kC;
    if (kernel == 0)
      return kernel_info(gat_block_fwd<T, C>, Sm<T, C>::FWD_BYTES, what);
    if (kernel == 1)
      return kernel_info(gat_block_bwd<T, C>, Sm<T, C>::BWD_BYTES, what);
    return kernel_info(gat_block_wgrad<T, C>, wgrad_smem<T>(), what);
  });
}

// Forward, one CTA per tile of G samples (ntiles = ceil(B / G)). dtype: 0 =
// float32, 1 = bfloat16 (x, w, out, ops); c: the embed width (128 or 64; 8
// heads). ops: [B * J, op_cols(c)]; x1s: [B * J, c] f32. thr/scl: (attn,
// proj, mlp, path) keep thresholds and scales. masks (may be null): the
// export buffer, laid out attn [B,H,J,J] | proj [B,J,C] | dp1 [B] | mlp1
// [B,J,4C] | mlp2 [B,J,C] | dp2 [B]. Returns the cudaError_t of the
// launch, -1 for a width the kernels are not built for.
extern "C" int gat_block_train_fwd(int dtype, int c, const void* x,
                                   const void* bias, const void* xm,
                                   const void* w, const void* offs,
                                   void* out, void* ops, void* x1s,
                                   void* masks, int B, int J, int G,
                                   int ntiles, unsigned seed, int unit,
                                   int sample0, unsigned t_attn,
                                   float s_attn, unsigned t_proj,
                                   float s_proj, unsigned t_mlp, float s_mlp,
                                   unsigned t_path, float s_path,
                                   void* stream) {
  using namespace gator::gtrain;
  const unsigned thr[4] = {t_attn, t_proj, t_mlp, t_path};
  const float scl[4] = {s_attn, s_proj, s_mlp, s_path};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, c, [&](auto tag) {
    using T = typename decltype(tag)::Type;
    constexpr int C = decltype(tag)::kC;
    auto a = make_args<T>(x, bias, xm, w, offs, ops, x1s, B, J, G, seed,
                          unit, sample0, thr, scl);
    a.out = static_cast<T*>(out);
    a.masks = static_cast<float*>(masks);
    return launch_smem(gat_block_fwd<T, C>, dim3(ntiles),
                       Sm<T, C>::FWD_BYTES, s, a);
  });
}

// Backward: gat_block_bwd (one CTA per tile; the tiles' small gradients to
// spart [ntiles, sstride]), gat_block_wgrad (the weight tiles, 68 at c =
// 128 and 18 at c = 64, x nc_w chunks of wper rows into wpart [nc_w,
// wstride]), then the two reductions in order into wgrads [wstride] and
// sgrads [sstride] (f32). goffs: each field's offset in its gradient row
// (the ten weights in wpart's, the rest and the hop/path bias in spart's).
// ops and x1s as the forward left them.
extern "C" int gat_block_train_bwd(
    int dtype, int c, const void* x, const void* bias, const void* xm,
    const void* w, const void* offs, const void* goffs, const void* gout,
    void* ops, void* x1s, void* dx, void* spart, long long sstride,
    void* wpart, long long wstride, void* sgrads, void* wgrads, int B, int J,
    int G, int ntiles, int nc_w, int wper, unsigned seed, int unit,
    int sample0, unsigned t_attn, float s_attn, unsigned t_proj,
    float s_proj, unsigned t_mlp, float s_mlp, unsigned t_path, float s_path,
    void* stream) {
  using namespace gator::gtrain;
  const unsigned thr[4] = {t_attn, t_proj, t_mlp, t_path};
  const float scl[4] = {s_attn, s_proj, s_mlp, s_path};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, c, [&](auto tag) {
    using T = typename decltype(tag)::Type;
    constexpr int C = decltype(tag)::kC;
    auto a = make_args<T>(x, bias, xm, w, offs, ops, x1s, B, J, G, seed,
                          unit, sample0, thr, scl);
    a.goffs = static_cast<const int*>(goffs);
    a.gout = static_cast<const T*>(gout);
    a.out = static_cast<T*>(dx);
    a.spart = static_cast<float*>(spart);
    a.sstride = sstride;
    return run_bwd<T, C>(a, ntiles, static_cast<float*>(wpart), wstride,
                         nc_w, wper, static_cast<float*>(sgrads),
                         static_cast<float*>(wgrads), s);
  });
}
