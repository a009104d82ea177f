// K1: the whole GAT trunk (all blocks) of the serving path, one launch.
//
// Replaces gator_tpu/nn/pallas_gat.py:266 `gat_blocks_fused` (kernel body
// `_trunk_kernel:166`). Per block and sample (reference:
// lib/models/GAT.py:16-43):
//   y  = LN1(x)
//   z  = BiasAttn(y, hop/path bias) + MGCN(y)
//   x += XFeat(z)                    (two hop-ring masks, widths C and C/8)
//   x += MLP(LN2(x))                 (exact GELU, hidden 4C)
// at embed width C = 128 or 64, 8 heads (`Width`).
//
// Design. One CTA holds a tile of G whole samples (G * J <= RT token rows:
// 80 in bf16, 48 in f32) for the whole trunk: the token rows are read from
// device memory once and written once, and every intermediate stays in
// shared memory, in T wherever it only enters a product (the residual
// stream x stays f32). Every dense product (qkv, proj, MGCN W0 and W1,
// XFeat x0, x1 and back, fc1, fc2) runs on the tensor cores through
// csrc/mma.cuh: bf16 mma.sync with f32 accumulation (fragments by
// ldmatrix), or 3xTF32 in f32. The operands are rounded to T where they
// enter a product, so the bf16 products are exact and only the order of
// the sums differs from the plain version. The weights come as [KP, 64]
// panels (KP = 64 in bf16, 32 in f32), packed on the host in the order the
// kernel takes them (nn/gat_trunk.py `pack_panels`), and stream through a
// ring of cp.async slots that never drains across products and blocks;
// warp w owns rows 16 * (w / 2) .. + 16 and columns 32 * (w % 2) .. + 32
// of each panel and keeps its sums over the depth in registers. The MLP
// takes its 4C hidden units in chunks of 64 (fc1's chunk, then its share
// of fc2 into register accumulators). A block's vectors and [J, C] tables
// (biases, LayerNorm weights, MGCN's M and diag(adj) * M) are staged in
// shared memory as f32 at the block's start, so the products' epilogues
// read no device memory. The per-sample J x J mixes (attention over J keys
// with the hop/path bias, MGCN's off-diagonal adjacency, XFeat's two hop
// rings) are ~3 % of the work. They run on the tensor cores too (`mix`,
// `attention_tc`; the f32 attention as FMA loops), each attention score
// formed once and kept in registers. The MGCN adjacency diagonal is folded into
// the modulation on the host (mdiag = diag(adj) * M), as the TPU kernel
// does.
//
// What bounds it on the H100 (C = 128): the operations, ~4.7 MFMA per
// sample and block (J = 17): 0.116 ms for six blocks at B = 2048 on bf16
// tensor cores; the bytes the function needs (x in, out) take 0.005 ms.
// Each CTA reads a block's weight panels (0.56 MB in bf16) once through
// L2, so more rows per CTA cut that traffic: ~1.7 GB per B = 2048 call at
// 68 rows a CTA. One CTA fits an SM (~225 KB of shared memory, eleven warps in
// bf16); the wrapper (nn/gat_trunk.py `launch_plan`) chooses G from B so
// that the CTAs spread evenly over the SMs (B = 256: 128 CTAs of 2
// samples). The kernel takes about 12 times its bound at B = 2048
// (chip_smoke.py phase 7 prints it beside the bound;
// tools/trunk_phases.py splits a CTA's cycles by phase): the products'
// mma.sync and ldmatrix issue, a panel and a barrier at a time, and the
// exact-erf GELU of the MLP's epilogues, the LayerNorms, the attention and
// the constants' staging, which run between barriers with no products
// beside them.
#include "mma.cuh"

namespace gator {
namespace trunk {

// The widths of a block at embed width C (gator_tpu/models/gat.py: 8
// heads, MLP ratio 4; the XFeat second ring C / 8, gator_tpu/nn/graph.py).
// The kernel is built for C = 128 and C = 64; at C = 64 the head width is
// 8 and the XFeat concat 72, which the products take zero-padded to 80 (the
// mma k-step of 16), adding exact zeros.
template <int C_>
struct Width {
  static constexpr int C = C_;
  static constexpr int H = 8;          // heads
  static constexpr int D = C / H;      // head width
  static constexpr int C3 = 3 * C;     // qkv width
  static constexpr int HID = 4 * C;    // MLP hidden
  static constexpr int C2 = C / 8;     // second XFeat ring width
  static constexpr int CF = C + C2;    // XFeat concat width
  static constexpr int CFP = (CF + 15) / 16 * 16;  // the concat, padded
  // D^-0.5 as f32 (the JAX kernel's `d ** -0.5`)
  static constexpr float SCALE = D == 16 ? 0.25f : 0.35355339059327373f;
  static_assert(C == 128 || C == 64, "K1 is built for C = 128 and 64");
};

constexpr int H = 8;      // heads
constexpr int JMAX = 19;  // most joints a sample may have
constexpr int NP = 64;    // columns of a weight panel
constexpr int HC = 64;    // MLP hidden units per chunk

// Field order of one block's packed weights; must match
// gator_tpu_torch/nn/gat_trunk.py TRUNK_FIELDS. The kernel reads the
// vectors and [J, *] tables from here; the matrices come as panels.
enum Field {
  LN1_W, LN1_B, QKV_W, QKV_B, PROJ_W, PROJ_B,
  GCN_W0, GCN_W1, GCN_M, GCN_MDIAG, GCN_OFF, GCN_B,
  X0_W, X0_B, X1_W, X1_B, BACK_W, BACK_B,
  LN2_W, LN2_B, FC1_W, FC1_B, FC2_W, FC2_B, NFIELD
};

// A block's constants as staged in shared memory (f32): where each field
// starts, in order; M and mdiag hold J rows of C.
template <int C>
struct Konst {
  using W = Width<C>;
  static constexpr int LN1W = 0, LN1B = LN1W + C, QKVB = LN1B + C,
                       PROJB = QKVB + W::C3, GCNB = PROJB + C,
                       X0B = GCNB + C, X1B = X0B + C, BACKB = X1B + W::C2,
                       LN2W = BACKB + C, LN2B = LN2W + C, FC1B = LN2B + C,
                       FC2B = FC1B + W::HID, M = FC2B + C,
                       MDIAG = M + JMAX * C, N = MDIAG + JMAX * C;
};

// The tile and its shared memory, in bytes from the start. Row strides
// are padded by 16 bytes (E elements of T; 4 floats for X) so that a
// warp's fragment loads fall in distinct banks. Must match
// nn/gat_trunk.py TILE_ROWS and smem_bytes.
template <typename T, int C>
struct Tile {
  using W = Width<C>;
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int MT = sizeof(T) == 2 ? 5 : 3;  // 16-row tiles
  static constexpr int RT = 16 * MT;                 // token rows
  // two warps per 16-row tile, then the warp that copies the panels
  static constexpr int NT = 64 * MT + 32;
  static constexpr int KP = sizeof(T) == 2 ? 64 : 32;  // panel depth
  static constexpr int NSLOT = sizeof(T) == 2 ? 4 : 3;  // ring slots
  static constexpr int LX = C + 4, LT = C + E, LP = W::C3 + E,
                       LO = W::CFP + E;
  // ZF, the f32 sum that becomes z, sits in P past the T columns [0, ZC)
  // that hold M * g1; later f1p sits at column ZC
  static constexpr int ZC = C + E;
  static constexpr int LZ = LP * (int)sizeof(T) / 4;
  static constexpr int SLOT = KP * NP;  // elements of a panel
  static constexpr int LJ = 32 + E;  // row stride of a [32, 32] table
  // X: the residual stream (f32). Y: y, then z, then y2. P: qkv, then
  // M * g1 | ZF, then f0p | f1p, then the MLP's chunk of hidden units. O:
  // the attention output, then the ring sums f0 | f1 (zero from CF to
  // CFP). TAB (T): the two hop-ring masks, then the block's MGCN
  // off-diagonal adjacency, each [J, J] zero-padded to [32, 32] (`mix`).
  // KV (f32): the block's constants (`Konst`). HB (f32): the [H, J, J]
  // hop/path bias.
  static constexpr int XS = 0, YS = XS + RT * LX * 4,
                       PS = YS + RT * LT * (int)sizeof(T),
                       OS = PS + RT * LP * (int)sizeof(T),
                       RING = OS + RT * LO * (int)sizeof(T),
                       TAB = RING + NSLOT * SLOT * (int)sizeof(T),
                       KV = TAB + 3 * 32 * LJ * (int)sizeof(T),
                       HB = KV + Konst<C>::N * 4,
                       BYTES = HB + H * JMAX * JMAX * 4;
  static_assert(BYTES <= 232448, "one CTA fits an SM");
  static_assert(ZC * (int)sizeof(T) + 4 * C <= LP * (int)sizeof(T),
                "P holds M * g1 and ZF side by side");
  static_assert(C % KP == 0 && HC % KP == 0 && W::CFP % 16 == 0 &&
                    W::CFP % KP <= 16,
                "panels cover the products' depths");
};

// The products of a block in the order they run (depth K, width N); the
// MLP follows them (`MLP_PANEL`).
enum Prod { P_QKV, P_W1, P_PROJ, P_W0, P_X0, P_X1, P_BACK, NPROD };

template <int C>
__host__ __device__ constexpr int prod_k(int k) {
  return k == P_BACK ? Width<C>::CF : C;
}
template <int C>
__host__ __device__ constexpr int prod_n(int k) {
  return k == P_QKV ? Width<C>::C3 : k == P_X1 ? Width<C>::C2 : C;
}
// [KP, NP] panels of product k: its depth panels for each column panel
template <int C>
__host__ __device__ constexpr int prod_panels(int k, int kp) {
  return (prod_k<C>(k) + kp - 1) / kp * ((prod_n<C>(k) + NP - 1) / NP);
}
// the block's panel index of product k's first panel
template <int C>
__host__ __device__ constexpr int prod_first(int k, int kp) {
  return k == 0 ? 0 : prod_first<C>(k - 1, kp) + prod_panels<C>(k - 1, kp);
}

// The weight panels of the whole trunk, in the order the products take
// them, block by block (nn/gat_trunk.py `pack_panels`): each a [KP, 64]
// block of a weight matrix, zero past the matrix's edge, stored whole and
// contiguous with the 16-byte pieces of row k permuted (`mma_panel`), so
// that a copy is contiguous and the fragment loads fall in distinct banks.
// They stream through NSLOT ring slots: while panel i is in use, panels
// i + 1 .. i + NSLOT - 2 are in flight, across the products' ends and the
// phases between them, so the ring never drains. The CTA's last warp
// issues the copies (it owns no rows of the products, so the others go on
// to their products at once); every thread takes part in every call.
template <typename T, int C>
struct Ring {
  using L = Tile<T, C>;
  // MLP: per chunk of HC hidden units, fc1's depth panels, then fc2's for
  // each of the NH column panels (halves at C = 128)
  static constexpr int NH = C / NP;
  static constexpr int P1 = C / L::KP, P2 = HC / L::KP, PCH = P1 + NH * P2;
  static constexpr int MLP_PANEL = prod_first<C>(NPROD, L::KP);
  static constexpr int PER_BLOCK = MLP_PANEL + Width<C>::HID / HC * PCH;
  T* buf;
  const T* panels;
  int total;   // panels of the trunk
  int issued;  // panels issued so far

  // the copying warp: copy the next panel into its slot (an empty group
  // past the last)
  __device__ void issue() {
    if (threadIdx.x >= L::NT - 32) {
      if (issued < total) {
        constexpr int V = 16 / (int)sizeof(T);
        T* dst = buf + (issued % L::NSLOT) * L::SLOT;
        const T* src = panels + (size_t)issued * L::SLOT;
        for (int i = (threadIdx.x & 31) * V; i < L::SLOT; i += 32 * V)
          tc::cp_async16(dst + i, src + i);
      }
      tc::cp_async_commit();
    }
    ++issued;
  }

  __device__ void start() {
    for (int i = 0; i < L::NSLOT - 1; ++i) issue();
  }

  // Panel i, once the copying warp's copies of it have landed; the
  // barrier also frees panel i - 1's slot for panel i + NSLOT - 1 and makes
  // what the previous phase wrote visible.
  __device__ const T* acquire(int i) {
    tc::cp_async_wait<L::NSLOT - 2>();
    __syncthreads();
    issue();
    return buf + (i % L::NSLOT) * L::SLOT;
  }
};

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_addr(p)));
}

// A warp's 16 rows of a product's A operand: T in shared memory, lda
// apart (rows 16-byte aligned), from row m0.
template <typename T>
struct ARows {
  const T* a;
  int lda, m0;
};

// acc[j] += A[m0:m0+16, k0:k0+KD] @ S[0:KD, n0+8j:n0+8j+8] for
// n0 + 8j < nw, on the tensor cores (one warp; the sum over the depth in a
// fixed order); S: a ring slot. bf16: each 16-deep step loads A's
// fragment with one ldmatrix and B's for two column tiles with one more, a
// step ahead of their products (the asm statements keep their order, so
// the source sets the schedule); the eight 16-byte pieces of slot row k
// sit at piece ^ (k & 7).
template <int KD>
__device__ __forceinline__ void mma_panel(float (&acc)[4][4],
                                          const ARows<__nv_bfloat16>& ar,
                                          int k0, const __nv_bfloat16* S,
                                          int n0, int nw) {
  if (n0 >= nw) return;
  const int lane = threadIdx.x & 31, k = lane & 15, sw = lane & 7;
  const __nv_bfloat16* pa =
      ar.a + (ar.m0 + k) * ar.lda + k0 + (lane >> 4) * 8;
  const int piece = n0 / 8 + (lane >> 4);
  const __nv_bfloat16* pb[2] = {S + k * NP + ((piece ^ sw) << 3),
                                S + k * NP + (((piece + 2) ^ sw) << 3)};
  const bool two = n0 + 16 < nw;  // both column pairs (else the first)
  uint32_t a[2][4], b[2][2][4];
  auto load = [&](int st, int kk) {
    ldsm_x4(a[st], pa + kk);
    tc::ldsm_x4_trans(b[st][0], pb[0] + kk * NP);
    if (two) tc::ldsm_x4_trans(b[st][1], pb[1] + kk * NP);
  };
  load(0, 0);
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks) {
    const int st = ks & 1;
    if (ks + 1 < KD / 16) load(st ^ 1, (ks + 1) * 16);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      if (jp == 1 && !two) continue;
      const uint32_t b0[2] = {b[st][jp][0], b[st][jp][1]},
                     b1[2] = {b[st][jp][2], b[st][jp][3]};
      tc::mma_bf16(acc[2 * jp], a[st], b0);
      tc::mma_bf16(acc[2 * jp + 1], a[st], b1);
    }
  }
}

// element (k, n) of an f32 ring slot, whose sixteen 16-byte pieces of row
// k sit at piece ^ ((k & 7) << 1)
struct SlotF32 {
  const float* p;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return p[k * NP + (((n >> 2) ^ ((k & 7) << 1)) << 2) + (n & 3)];
  }
};

// f32: the 3xTF32 products of mma.cuh, fragments read element by element
template <int KD>
__device__ __forceinline__ void mma_panel(float (&acc)[4][4],
                                          const ARows<float>& ar, int k0,
                                          const float* S, int n0, int nw) {
  using P = tc::Mma<float>;
  const tc::RowMajor<float> fa{ar.a + k0, ar.lda};
  const SlotF32 fb{S};
#pragma unroll
  for (int kk = 0; kk < KD; kk += P::KS) {
    const P::A a = P::load_a(fa, ar.m0, kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + 8 * j < nw) P::mma(acc[j], a, P::load_b(fb, kk, n0 + 8 * j));
  }
}

// the warp's sums to out(row, col, v, v') for columns col, col + 1
template <class Out>
__device__ __forceinline__ void emit(const float (&acc)[4][4], int m0,
                                     int n0, int nw, int c0, Out out) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (n0 + 8 * j >= nw) continue;
    const int n = c0 + n0 + 8 * j + 2 * t;
    out(m0 + g, n, acc[j][0], acc[j][1]);
    out(m0 + g + 8, n, acc[j][2], acc[j][3]);
  }
}

// out(r, n, v, v') with (v, v') = (A @ W)[r, n:n+2] for the rows of the
// tile's mt 16-row tiles and even n < N, W the weight of product PK of
// block blk: A [*, K] T in shared memory (lda apart; a depth past the
// last whole panel is read 16 wide, A zero past K). Ends with a barrier:
// the outputs are then visible.
template <typename T, int C, int PK, class Out>
__device__ void product(Ring<T, C>& ring, int blk, int mt, const T* A,
                        int lda, Out out) {
  constexpr int KP = Tile<T, C>::KP, K = prod_k<C>(PK), N = prod_n<C>(PK);
  constexpr int NK = (K + KP - 1) / KP, NN = (N + NP - 1) / NP;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
  const bool active = m0 < 16 * mt;
  int i = blk * Ring<T, C>::PER_BLOCK + prod_first<C>(PK, KP);
  const ARows<T> ar{A, lda, m0};
  float acc[4][4];
  for (int nb = 0; nb < NN; ++nb) {
    const int nw = min(NP, N - nb * NP);
#pragma unroll
    for (int kb = 0; kb < NK; ++kb) {
      const T* s = ring.acquire(i++);
      if (!active) continue;
      if (kb == 0) zero(acc);
      if (K - kb * KP >= KP)
        mma_panel<KP>(acc, ar, kb * KP, s, n0, nw);
      else
        mma_panel<16>(acc, ar, kb * KP, s, n0, nw);
      if (kb == NK - 1) emit(acc, m0, n0, nw, nb * NP, out);
    }
  }
  __syncthreads();
}

// A sample's rows of a T buffer (ld apart) as an mma B operand: element
// (k, n) is row k, column n; rows past `last` repeat it (their weights in
// the A operand are zero, and the repeated rows are finite).
template <typename T>
struct SampleRows {
  static constexpr tc::Layout kLayout =
      sizeof(T) == 2 ? tc::kRowMajor : tc::kNone;
  const T* p;
  int ld, last;
  __device__ __forceinline__ const T* ptr(int i, int j) const {
    return p + min(i, last) * ld + j;
  }
  __device__ __forceinline__ float operator()(int i, int j) const {
    return Num<T>::to_float(*ptr(i, j));
  }
};

// The per-sample J x J mix on the tensor cores: out(r, c, v, v') with
// (v, v') = (A @ S_g)[n, c:c+2] for each of the tile's ns samples g, joint
// n < J (r = g * J + n) and even column c < N, where A is a [J, J] table
// zero-padded to [32, 32] in `tab` (LJ apart) and S_g the sample's J rows
// of src (ld apart). A warp takes one (sample, 16-row tile, 32 columns) at
// a time; the depth runs over the first J of 32 (A is zero past J).
template <typename T, int C, class Out>
__device__ __forceinline__ void mix(const T* tab, const T* src, int ld,
                                    int N, int ns, int J, Out out) {
  using P = tc::Mma<T>;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int ncg = (N + 31) / 32;
  const tc::RowMajor<T> fa{tab, Tile<T, C>::LJ};
  for (int it = warp; it < ns * 2 * ncg; it += Tile<T, C>::NT / 32) {
    const int smp = it / (2 * ncg), m0 = (it / ncg) % 2 * 16;
    const int n0 = it % ncg * 32;
    if (m0 >= J) continue;
    const SampleRows<T> fb{src + smp * J * ld, ld, J - 1};
    float acc[4][4];
    zero(acc);
    for (int k0 = 0; k0 < J; k0 += P::KS) {
      const typename P::A a = P::load_a(fa, m0, k0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + 8 * j < N) P::mma(acc[j], a, P::load_b(fb, k0, n0 + 8 * j));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + 8 * j >= N) continue;
      const int c = n0 + 8 * j + 2 * t;
      if (m0 + g < J) out(smp * J + m0 + g, c, acc[j][0], acc[j][1]);
      if (m0 + g + 8 < J) out(smp * J + m0 + g + 8, c, acc[j][2], acc[j][3]);
    }
  }
}

// N consecutive values of T (16-byte aligned; N a multiple of 8) as f32
template <int N>
__device__ __forceinline__ void loadv(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 u = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = u.x;
    v[4 * i + 1] = u.y;
    v[4 * i + 2] = u.z;
    v[4 * i + 3] = u.w;
  }
}

template <int N>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p,
                                      float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 b;
      memcpy(&b, &w[k], sizeof(b));
      const float2 f = __bfloat1622float2(b);
      v[8 * i + 2 * k] = f.x;
      v[8 * i + 2 * k + 1] = f.y;
    }
  }
}

// Per-sample attention with the hop/path bias (f32), one thread per (head,
// row) of the tile's `rows` (zeros past the R real ones): the J scores of
// the row are formed once and kept in registers, then o = prob @ v.
template <typename T, int C>
__device__ __forceinline__ void attention(const T* P, T* O,
                                          const float* bias, int R, int rows,
                                          int J) {
  using L = Tile<T, C>;
  constexpr int D = Width<C>::D;
  for (int task = threadIdx.x; task < H * rows; task += L::NT) {
    const int h = task / rows, r = task % rows;
    float o[D];
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = 0.0f;
    if (r < R) {
      const int g = r / J, n = r % J;
      float q[D];
      loadv(P + r * L::LP + h * D, q);
      const T* kb = P + g * J * L::LP + C + h * D;
      const T* vb = kb + C;
      const float* brow = bias + (h * J + n) * J;
      float s[JMAX];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int m = 0; m < JMAX; ++m) {
        if (m < J) {
          float k[D];
          loadv(kb + m * L::LP, k);
          float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int d = 0; d < D; ++d) a[d & 3] = fmaf(q[d], k[d], a[d & 3]);
          s[m] = ((a[0] + a[1]) + (a[2] + a[3])) * Width<C>::SCALE +
                 brow[m];
          mx = fmaxf(mx, s[m]);
        }
      }
      float sum = 0.0f;
#pragma unroll
      for (int m = 0; m < JMAX; ++m) {
        if (m < J) {
          s[m] = expf(s[m] - mx);
          sum += s[m];
        }
      }
#pragma unroll
      for (int m = 0; m < JMAX; ++m) {
        if (m < J) {
          const float pr = rnd<T>(s[m] / sum);
          float v[D];
          loadv(vb + m * L::LP, v);
#pragma unroll
          for (int d = 0; d < D; ++d) o[d] = fmaf(pr, v[d], o[d]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < D; d += 2)
      st2(O + r * L::LO + h * D + d, o[d], o[d + 1]);
  }
}

// bf16: the same on the tensor cores, one warp per (sample, head, 16-row
// tile): S = q k^T for 32 keys (those past J masked), the row softmax
// across each quad of lanes, the probabilities rounded to bf16 straight
// into the A fragments of o = prob @ v. bias: the [H, J, J] hop/path bias
// in shared memory. Rows and keys past J read the
// sample's last row (finite; their probabilities are 0 or never stored).
// At D = 8 the fragments' depth 8..15 (the next head's columns) are
// zeroed, so q k^T adds exact zeros, and o takes one 8-column tile.
template <int C>
__device__ __forceinline__ void attention_tc(const __nv_bfloat16* P,
                                             __nv_bfloat16* O,
                                             const float* bias, int ns,
                                             int J) {
  using L = Tile<__nv_bfloat16, C>;
  constexpr int D = Width<C>::D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int it = warp; it < ns * H * 2; it += L::NT / 32) {
    const int smp = it / (2 * H), h = it / 2 % H, m0 = it % 2 * 16;
    if (m0 >= J) continue;
    const __nv_bfloat16* base = P + smp * J * L::LP + h * D;
    uint32_t qa[4];
    ldsm_x4(qa, base + min(m0 + (lane & 15), J - 1) * L::LP + (lane >> 4) * 8);
    if constexpr (D == 8) qa[2] = qa[3] = 0u;
    float sc[4][4];
    zero(sc);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t kb[4];
      const int key = jp * 16 + (lane >> 4) * 8 + (lane & 7);
      ldsm_x4(kb, base + min(key, J - 1) * L::LP + C + ((lane >> 3) & 1) * 8);
      if constexpr (D == 8) kb[1] = kb[3] = 0u;
      const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
      tc::mma_bf16(sc[2 * jp], qa, b0);
      tc::mma_bf16(sc[2 * jp + 1], qa, b1);
    }
    // rows m0 + g (u = 0) and m0 + g + 8 (u = 1): scale, bias, softmax
    float inv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* brow = bias + (h * J + min(m0 + g + 8 * u, J - 1)) * J;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * t + e;
          float& v = sc[j][2 * u + e];
          v = key < J ? v * Width<C>::SCALE + brow[key] : -CUDART_INF_F;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[j][2 * u + e];
          v = expf(v - mx);
          sum += v;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[u] = 1.0f / sum;
    }
    float o[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* lo = sc[2 * kk];
      const float* hi = sc[2 * kk + 1];
      const uint32_t pa[4] = {
          tc::pack_bf16(lo[0] * inv[0], lo[1] * inv[0]),
          tc::pack_bf16(lo[2] * inv[1], lo[3] * inv[1]),
          tc::pack_bf16(hi[0] * inv[0], hi[1] * inv[0]),
          tc::pack_bf16(hi[2] * inv[1], hi[3] * inv[1])};
      uint32_t vb[4];
      tc::ldsm_x4_trans(vb, base + min(kk * 16 + (lane & 15), J - 1) * L::LP +
                                2 * C + (lane >> 4) * 8);
      const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
      tc::mma_bf16(o[0], pa, b0);
      if constexpr (D == 16) tc::mma_bf16(o[1], pa, b1);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = m0 + g + 8 * u;
      if (n >= J) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        st2(O + (smp * J + n) * L::LO + h * D + 8 * j + 2 * t, o[j][2 * u],
            o[j][2 * u + 1]);
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(Tile<T, C>::NT, 1)
    gat_trunk_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                     const float* __restrict__ masks,
                     const T* __restrict__ weights,
                     const int* __restrict__ offs, long long wstride,
                     const T* __restrict__ panels, int nblk,
                     T* __restrict__ out, int B, int J, int G) {
  using L = Tile<T, C>;
  using W = Width<C>;
  using K = Konst<C>;
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char sm[];
  float* X = at<float>(sm, L::XS);
  T* Y = at<T>(sm, L::YS);
  T* P = at<T>(sm, L::PS);
  float* ZF = at<float>(sm, L::PS + L::ZC * (int)sizeof(T));
  T* O = at<T>(sm, L::OS);
  T* TAB = at<T>(sm, L::TAB);  // hop-ring masks 0 and 1, MGCN adj_off
  T* OFFT = TAB + 2 * 32 * L::LJ;
  float* KV = at<float>(sm, L::KV);
  float* HB = at<float>(sm, L::HB);
  Ring<T, C> ring{at<T>(sm, L::RING), panels, nblk * Ring<T, C>::PER_BLOCK,
                  0};
  ring.start();

  const int s0 = blockIdx.x * G;
  const int R = min(G, B - s0) * J;  // real token rows of this CTA
  const int mt = (R + 15) / 16, rows = 16 * mt;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
  const bool active = m0 < rows;

  const T* xin = x + (size_t)s0 * J * C;
  for (int i = tid; i < rows * C / 2; i += L::NT) {
    const int r = i / (C / 2), c = i % (C / 2) * 2;
    const float2 v = r < R ? ld2(xin + r * C + c) : make_float2(0.0f, 0.0f);
    X[r * L::LX + c] = v.x;
    X[r * L::LX + c + 1] = v.y;
  }
  for (int i = tid; i < H * J * J; i += L::NT) HB[i] = bias[i];
  // the padding rows of O stay zero (the attention and the ring sums
  // write the real rows only)
  for (int i = R * L::LO + tid; i < rows * L::LO; i += L::NT)
    O[i] = N::from_float(0.0f);
  // and so do its columns CF..CFP, the concat's padding to the k-step
  constexpr int OPAD = W::CFP - W::CF;
  for (int i = tid; i < R * OPAD; i += L::NT)
    O[i / OPAD * L::LO + W::CF + i % OPAD] = N::from_float(0.0f);
  for (int i = tid; i < 3 * 32 * L::LJ; i += L::NT) {
    const int tb = i / (32 * L::LJ), n = i / L::LJ % 32, m = i % L::LJ;
    TAB[i] = N::from_float(tb < 2 && n < J && m < J
                               ? masks[(tb * J + n) * J + m]
                               : 0.0f);
  }
  // the zeroed adjacency table is written again by the first block's
  // staging below, by other threads
  __syncthreads();

  for (int blk = 0; blk < nblk; ++blk) {
    // the block's constants into KV (f32) and its adj_off into OFFT, field
    // by field, each thread's loads all independent
    const T* p = weights + blk * wstride;
    {
      constexpr int NF = 15;
      constexpr int src[NF] = {LN1_W, LN1_B, QKV_B, PROJ_B, GCN_B, X0_B,
                               X1_B, BACK_B, LN2_W, LN2_B, FC1_B, FC2_B,
                               GCN_M, GCN_MDIAG, GCN_OFF};
      constexpr int dst[NF] = {K::LN1W, K::LN1B, K::QKVB, K::PROJB, K::GCNB,
                               K::X0B, K::X1B, K::BACKB, K::LN2W, K::LN2B,
                               K::FC1B, K::FC2B, K::M, K::MDIAG, 0};
      constexpr int most[NF] = {C, C, W::C3, C, C, C, W::C2, C, C, C,
                                W::HID, C, JMAX * C, JMAX * C, JMAX * JMAX};
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int n = f < 12 ? most[f] : f < 14 ? J * C : J * J;
        const T* from = p + offs[src[f]];
#pragma unroll
        for (int k = 0; k < (most[f] + L::NT - 1) / L::NT; ++k) {
          const int i = tid + k * L::NT;
          if (i >= n) continue;
          const float v = ld(from + i);
          if (f < NF - 1)
            KV[dst[f] + i] = v;
          else
            OFFT[i / J * L::LJ + i % J] = N::from_float(v);
        }
      }
    }
    __syncthreads();
    auto kv2 = [&](int at) {
      return *reinterpret_cast<const float2*>(KV + at);
    };

    // y = LN1(x)
    layer_norm_rows<C>(X, L::LX, rows, KV + K::LN1W, KV + K::LN1B, 1e-5f,
                       false, [&](int r, int c, float v) {
                         Y[r * L::LT + c] = N::from_float(v);
                       });

    // qkv = y @ Wqkv + b, rounded
    product<T, C, P_QKV>(ring, blk, mt, Y, L::LT,
               [&](int r, int n, float v0, float v1) {
                 const float2 b = kv2(K::QKVB + n);
                 st2(P + r * L::LP + n, v0 + b.x, v1 + b.y);
               });

    // o = softmax(q k^T / 4 + bias) v, per sample and head
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      attention_tc<C>(P, O, HB, R / J, J);
    else
      attention<T, C>(P, O, HB, R, rows, J);

    // MGCN: M * g1 with g1 = y @ W1 (rounded) over the dead q
    product<T, C, P_W1>(ring, blk, mt, Y, L::LT,
               [&](int r, int c, float v0, float v1) {
                 const float2 m = kv2(K::M + (r % J) * C + c);
                 st2(P + r * L::LP + c, v0 * m.x, v1 * m.y);
               });
    // ZF = attn = rounded o @ Wproj + b (over the dead k, v)
    product<T, C, P_PROJ>(ring, blk, mt, O, L::LO,
               [&](int r, int c, float v0, float v1) {
                 const float2 b = kv2(K::PROJB + c);
                 ZF[r * L::LZ + c] = rnd<T>(v0 + b.x);
                 ZF[r * L::LZ + c + 1] = rnd<T>(v1 + b.y);
               });
    // ZF += mdiag * g0 with g0 = y @ W0 (f32)
    product<T, C, P_W0>(ring, blk, mt, Y, L::LT,
               [&](int r, int c, float v0, float v1) {
                 const float2 m = kv2(K::MDIAG + (r % J) * C + c);
                 ZF[r * L::LZ + c] += m.x * v0;
                 ZF[r * L::LZ + c + 1] += m.y * v1;
               });
    // z = ZF + adj_off @ (M * g1) + b, rounded, per sample (over the dead
    // y)
    mix<T, C>(OFFT, P, L::LP, C, R / J, J,
           [&](int r, int c, float v0, float v1) {
             const float2 b = kv2(K::GCNB + c);
             st2(Y + r * L::LT + c, ZF[r * L::LZ + c] + v0 + b.x,
                 ZF[r * L::LZ + c + 1] + v1 + b.y);
           });

    // XFeat ring projections: f0p -> P[:, 0:C], f1p -> P[:, ZC:ZC+C2]
    product<T, C, P_X0>(ring, blk, mt, Y, L::LT,
               [&](int r, int c, float v0, float v1) {
                 const float2 b = kv2(K::X0B + c);
                 st2(P + r * L::LP + c, v0 + b.x, v1 + b.y);
               });
    product<T, C, P_X1>(ring, blk, mt, Y, L::LT,
               [&](int r, int c, float v0, float v1) {
                 const float2 b = kv2(K::X1B + c);
                 st2(P + r * L::LP + L::ZC + c, v0 + b.x, v1 + b.y);
               });
    // ring sums over each sample's hop masks -> O[:, 0:CF] (o is dead)
    mix<T, C>(TAB, P, L::LP, C, R / J, J,
           [&](int r, int c, float v0, float v1) {
             st2(O + r * L::LO + c, v0, v1);
           });
    mix<T, C>(TAB + 32 * L::LJ, P + L::ZC, L::LP, W::C2, R / J, J,
           [&](int r, int c, float v0, float v1) {
             st2(O + r * L::LO + C + c, v0, v1);
           });

    // x += [f0, f1] @ Wback + b
    product<T, C, P_BACK>(ring, blk, mt, O, L::LO,
               [&](int r, int c, float v0, float v1) {
                 const float2 b = kv2(K::BACKB + c);
                 X[r * L::LX + c] += v0 + b.x;
                 X[r * L::LX + c + 1] += v1 + b.y;
               });

    // x += fc2(gelu(fc1(LN2(x)))): per chunk of HC hidden units, fc1's
    // panels (depth C) into the chunk (over the dead f0p), then fc2's
    // (depth HC) for each of the NH column panels into acc2
    layer_norm_rows<C>(X, L::LX, rows, KV + K::LN2W, KV + K::LN2B, 1e-5f,
                       false, [&](int r, int c, float v) {
                         Y[r * L::LT + c] = N::from_float(v);
                       });
    using RG = Ring<T, C>;
    constexpr int P1 = RG::P1, P2 = RG::P2, NH = RG::NH;
    int i = blk * RG::PER_BLOCK + RG::MLP_PANEL;
    const ARows<T> ay{Y, L::LT, m0}, ah{P, L::LP, m0};  // y2, the chunk
    float acc1[4][4], acc2[NH][4][4];
#pragma unroll
    for (int half = 0; half < NH; ++half) zero(acc2[half]);
    for (int hc = 0; hc < W::HID / HC; ++hc) {
#pragma unroll
      for (int q = 0; q < P1; ++q) {
        const T* s = ring.acquire(i++);
        if (!active) continue;
        if (q == 0) zero(acc1);
        mma_panel<L::KP>(acc1, ay, q * L::KP, s, n0, NP);
        if (q == P1 - 1)
          emit(acc1, m0, n0, NP, 0, [&](int r, int c, float v0, float v1) {
            const float2 b = kv2(K::FC1B + hc * HC + c);
            st2(P + r * L::LP + c, gelu_exact(v0 + b.x),
                gelu_exact(v1 + b.y));
          });
      }
#pragma unroll
      for (int half = 0; half < NH; ++half)
#pragma unroll
        for (int kq = 0; kq < P2; ++kq) {
          const T* s = ring.acquire(i++);
          if (!active) continue;
          mma_panel<L::KP>(acc2[half], ah, kq * L::KP, s, n0, NP);
        }
    }
    if (active) {
      auto add = [&](int r, int c, float v0, float v1) {
        const float2 b = kv2(K::FC2B + c);
        X[r * L::LX + c] += v0 + b.x;
        X[r * L::LX + c + 1] += v1 + b.y;
      };
#pragma unroll
      for (int half = 0; half < NH; ++half)
        emit(acc2[half], m0, n0, NP, half * NP, add);
    }
    __syncthreads();
  }

  T* xo = out + (size_t)s0 * J * C;
  for (int i = tid; i < R * C / 2; i += L::NT) {
    const int r = i / (C / 2), c = i % (C / 2) * 2;
    st2(xo + r * C + c, X[r * L::LX + c], X[r * L::LX + c + 1]);
  }
}

template <typename T, int C>
int launch(const void* x, const void* bias, const void* masks,
           const void* weights, const void* offs, long long wstride,
           const void* panels, int nblk, void* out, int B, int J, int G,
           cudaStream_t stream) {
  using L = Tile<T, C>;
  auto kern = gat_trunk_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + G - 1) / G;
  kern<<<grid, L::NT, L::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(bias),
      static_cast<const float*>(masks), static_cast<const T*>(weights),
      static_cast<const int*>(offs), wstride, static_cast<const T*>(panels),
      nblk, static_cast<T*>(out), B, J, G);
  return (int)cudaGetLastError();
}

// what: 0 registers a thread, 1 CTAs resident per SM, 2 shared-memory
// bytes, 3 token rows a tile, 4 threads a CTA, 5 weight panels a block,
// 6 panel depth
template <typename T, int C>
int info(int what) {
  using L = Tile<T, C>;
  if (what == 2) return L::BYTES;
  if (what == 3) return L::RT;
  if (what == 4) return L::NT;
  if (what == 5) return Ring<T, C>::PER_BLOCK;
  if (what == 6) return L::KP;
  auto kern = gat_trunk_kernel<T, C>;
  cudaFuncAttributes attr;
  int per = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::BYTES) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kern) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, L::NT,
                                                    L::BYTES) != cudaSuccess)
    return -1;
  return what == 0 ? attr.numRegs : per;
}

// the instance for (dtype, c): f(Tag<T, C>{}); -1 for a width not built
template <typename T, int C>
struct Tag {};

template <typename T, int C, typename... A>
int launch_tag(Tag<T, C>, A... args) {
  return launch<T, C>(args...);
}

template <typename T, int C>
int info_tag(Tag<T, C>, int what) {
  return info<T, C>(what);
}

template <class F>
int dispatch(int dtype, int c, F f) {
  if (c == 128)
    return dtype == 0 ? f(Tag<float, 128>{}) : f(Tag<__nv_bfloat16, 128>{});
  if (c == 64)
    return dtype == 0 ? f(Tag<float, 64>{}) : f(Tag<__nv_bfloat16, 64>{});
  return -1;
}

}  // namespace trunk
}  // namespace gator

// dtype: 0 = float32, 1 = bfloat16; c: the embed width (128 or 64; 8
// heads). weights: the packed fields [nblk, wstride] with their offsets
// `offs`; panels: the weight panels of every block in the kernel's order
// (`gat_trunk_info(dtype, c, 5)` a block). G samples per CTA (G * J at
// most the tile's rows, `gat_trunk_info(dtype, c, 3)`). Returns the
// cudaError_t of the launch, -1 for a width the kernel is not built for.
extern "C" int gat_trunk_launch(int dtype, int c, const void* x,
                                const void* bias, const void* masks,
                                const void* weights, const void* offs,
                                long long wstride, const void* panels,
                                int nblk, void* out, int B, int J, int G,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return gator::trunk::dispatch(dtype, c, [&](auto tag) {
    return gator::trunk::launch_tag(tag, x, bias, masks, weights, offs,
                                    wstride, panels, nblk, out, B, J, G, s);
  });
}

// Registers a thread (what = 0), CTAs resident per SM (1), shared-memory
// bytes (2), token rows a tile (3), threads a CTA (4), weight panels a
// block (5) or panel depth (6) of the kernel for dtype (0 = float32, 1 =
// bfloat16) and embed width c; -1 if the query fails.
extern "C" int gat_trunk_info(int dtype, int c, int what) {
  return gator::trunk::dispatch(dtype, c, [&](auto tag) {
    return gator::trunk::info_tag(tag, what);
  });
}
