// K1: the whole GAT trunk (all blocks) of the serving path, one launch.
//
// Replaces gator_tpu/nn/pallas_gat.py:266 `gat_blocks_fused` (kernel body
// `_trunk_kernel:166`). Per block and sample (reference:
// lib/models/GAT.py:16-43):
//   y  = LN1(x)
//   z  = BiasAttn(y, hop/path bias) + MGCN(y)
//   x += XFeat(z)                    (two hop-ring masks, widths 128 and 16)
//   x += MLP(LN2(x))                 (exact GELU, hidden 512)
//
// Design. One CTA holds G samples (G*J <= 64 token rows) for the whole
// trunk: the token rows are read from device memory once and written once,
// and every intermediate stays in shared memory. Attention, MGCN and the
// XFeat ring sums are computed per sample on its own J x J structure; the
// block-diagonal [G*J, G*J] tiles, one-hot tiling matrices and J->32
// padding that the TPU kernel used to fill its matrix unit are gone. The
// MGCN adjacency diagonal is folded into the modulation on the host
// (mdiag = diag(adj) * M), as the TPU kernel does.
//
// What bounds it on the H100. The matmuls are FMA loops with f32
// accumulation (~9 MFLOP per sample and block); a block's weights (~266k
// values) are streamed from L2 by every CTA, so L2 traffic scales with
// B*J / RM times the weight bytes. The design keeps RM = 8 rows per thread
// tile to cut that traffic, and T = bf16 halves it. Tensor cores (mma /
// wgmma) are the next step.
#include "common.cuh"

namespace gator {
namespace trunk {

constexpr int C = 128;    // embed width
constexpr int H = 8;      // heads
constexpr int D = 16;     // head width
constexpr int C3 = 384;   // qkv width
constexpr int HID = 512;  // MLP hidden
constexpr int C2 = 16;    // second XFeat ring width
constexpr int CF = 144;   // XFeat concat width
constexpr int HC = 256;   // MLP hidden chunk
constexpr int NT = 512;   // threads per CTA

// Field order of one block's packed weights; must match
// gator_tpu_torch/nn/gat_trunk.py TRUNK_FIELDS.
enum Field {
  LN1_W, LN1_B, QKV_W, QKV_B, PROJ_W, PROJ_B,
  GCN_W0, GCN_W1, GCN_M, GCN_MDIAG, GCN_OFF, GCN_B,
  X0_W, X0_B, X1_W, X1_B, BACK_W, BACK_B,
  LN2_W, LN2_B, FC1_W, FC1_B, FC2_W, FC2_B, NFIELD
};

template <typename T>
__global__ void __launch_bounds__(NT)
    gat_trunk_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                     const float* __restrict__ masks,
                     const T* __restrict__ weights,
                     const int* __restrict__ offs, long long wstride,
                     int nblk, T* __restrict__ out, int B, int J, int G) {
  extern __shared__ __align__(16) float smem[];
  const int rp = round_up(G * J, RM);
  float* X = smem;           // [rp, C]   residual stream
  float* Y = X + rp * C;     // [rp, CF]  LN outputs, XFeat ring sums
  float* Q = Y + rp * CF;    // [rp, C3]  qkv | attn,h0,h1 | f0,f1 | hidden
  float* A = Q + rp * C3;    // [rp, C]   attention output, then z
  float* sb = A + rp * C;    // [H, J, J] hop/path bias
  float* sm = sb + H * J * J;  // [2, J, J] XFeat ring masks

  const int s0 = blockIdx.x * G;
  const int R = min(G, B - s0) * J;  // real token rows of this CTA
  const int tid = threadIdx.x;
  const float scale = rsqrtf((float)D);

  for (int i = tid; i < H * J * J; i += NT) sb[i] = bias[i];
  for (int i = tid; i < 2 * J * J; i += NT) sm[i] = masks[i];
  const T* xin = x + (size_t)s0 * J * C;
  for (int i = tid; i < R * C; i += NT) X[i] = Num<T>::to_float(xin[i]);
  __syncthreads();

  for (int blk = 0; blk < nblk; ++blk) {
    const T* p = weights + blk * wstride;
    const T* ln1_w = p + offs[LN1_W];
    const T* ln1_b = p + offs[LN1_B];
    const T* qkv_b = p + offs[QKV_B];
    const T* proj_b = p + offs[PROJ_B];
    const T* gcn_m = p + offs[GCN_M];
    const T* gcn_mdiag = p + offs[GCN_MDIAG];
    const T* gcn_off = p + offs[GCN_OFF];
    const T* gcn_b = p + offs[GCN_B];
    const T* x0_b = p + offs[X0_B];
    const T* x1_b = p + offs[X1_B];
    const T* back_b = p + offs[BACK_B];
    const T* fc1_b = p + offs[FC1_B];
    const T* fc2_b = p + offs[FC2_B];

    // y = LN1(x)
    layer_norm_rows<C>(X, C, R, ln1_w, ln1_b, 1e-5f, false,
                       [&](int r, int c, float v) { Y[r * CF + c] = rnd<T>(v); });
    __syncthreads();

    // qkv = y @ Wqkv + b
    gemm<T>(Y, CF, R, C, p + offs[QKV_W], C3, C3, [&](int r, int c, float v) {
      Q[r * C3 + c] = rnd<T>(v + ld(qkv_b + c));
    });
    __syncthreads();

    // per-sample attention with the hop/path bias; one thread per
    // (head, query row); two passes over the J keys (max/sum, then the
    // rounded probabilities times v)
    for (int task = tid; task < H * R; task += NT) {
      const int h = task / R;
      const int r = task % R;
      const int g = r / J;
      const int n = r % J;
      float q[D];
#pragma unroll
      for (int d = 0; d < D; ++d) q[d] = Q[r * C3 + h * D + d];
      const float* kb = Q + g * J * C3 + C + h * D;
      const float* vb = Q + g * J * C3 + 2 * C + h * D;
      const float* brow = sb + (h * J + n) * J;
      float mx = -CUDART_INF_F;
      for (int m = 0; m < J; ++m) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(q[d], kb[m * C3 + d], s);
        mx = fmaxf(mx, s * scale + brow[m]);
      }
      float sum = 0.0f;
      for (int m = 0; m < J; ++m) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(q[d], kb[m * C3 + d], s);
        sum += expf(s * scale + brow[m] - mx);
      }
      const float inv = 1.0f / sum;
      float o[D];
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = 0.0f;
      for (int m = 0; m < J; ++m) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(q[d], kb[m * C3 + d], s);
        const float pr = rnd<T>(expf(s * scale + brow[m] - mx) * inv);
#pragma unroll
        for (int d = 0; d < D; ++d) o[d] = fmaf(pr, vb[m * C3 + d], o[d]);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) A[r * C + h * D + d] = rnd<T>(o[d]);
    }
    __syncthreads();

    // attn = o @ Wproj + b -> Q[:, 0:C]; MGCN branches h0 -> Q[:, C:2C],
    // M * h1 -> Q[:, 2C:3C] (three products with disjoint outputs)
    gemm<T>(A, C, R, C, p + offs[PROJ_W], C, C, [&](int r, int c, float v) {
      Q[r * C3 + c] = rnd<T>(v + ld(proj_b + c));
    });
    gemm<T>(Y, CF, R, C, p + offs[GCN_W0], C, C,
            [&](int r, int c, float v) { Q[r * C3 + C + c] = v; });
    gemm<T>(Y, CF, R, C, p + offs[GCN_W1], C, C, [&](int r, int c, float v) {
      Q[r * C3 + 2 * C + c] = rnd<T>(v * ld(gcn_m + (r % J) * C + c));
    });
    __syncthreads();

    // z = attn + mdiag * h0 + adj_off @ (M * h1) + b   (per sample)
    for (int i = tid; i < R * C; i += NT) {
      const int r = i / C;
      const int c = i % C;
      const int g = r / J;
      const int n = r % J;
      float acc = Q[r * C3 + C + c] * ld(gcn_mdiag + n * C + c);
      const float* h1 = Q + g * J * C3 + 2 * C + c;
      const T* off = gcn_off + n * J;
      for (int m = 0; m < J; ++m) acc = fmaf(ld(off + m), h1[m * C3], acc);
      A[i] = rnd<T>(Q[r * C3 + c] + acc + ld(gcn_b + c));
    }
    __syncthreads();

    // XFeat ring projections: f0 -> Q[:, 0:C], f1 -> Q[:, C:CF]
    gemm<T>(A, C, R, C, p + offs[X0_W], C, C, [&](int r, int c, float v) {
      Q[r * C3 + c] = rnd<T>(v + ld(x0_b + c));
    });
    gemm<T>(A, C, R, C, p + offs[X1_W], C2, C2, [&](int r, int c, float v) {
      Q[r * C3 + C + c] = rnd<T>(v + ld(x1_b + c));
    });
    __syncthreads();

    // ring sums over each sample's hop masks -> Y[:, 0:CF]
    for (int i = tid; i < R * CF; i += NT) {
      const int r = i / CF;
      const int c = i % CF;
      const int g = r / J;
      const int n = r % J;
      const float* mrow = sm + ((c < C ? 0 : 1) * J + n) * J;
      const float* f = Q + g * J * C3 + c;
      float acc = 0.0f;
      for (int m = 0; m < J; ++m) acc = fmaf(mrow[m], f[m * C3], acc);
      Y[r * CF + c] = rnd<T>(acc);
    }
    __syncthreads();

    // x += [ring0, ring1] @ Wback + b
    gemm<T>(Y, CF, R, CF, p + offs[BACK_W], C, C, [&](int r, int c, float v) {
      X[r * C + c] += v + ld(back_b + c);
    });
    __syncthreads();

    // x += fc2(gelu(fc1(LN2(x)))), the hidden layer in chunks of HC
    layer_norm_rows<C>(X, C, R, p + offs[LN2_W], p + offs[LN2_B], 1e-5f, false,
                       [&](int r, int c, float v) { Y[r * CF + c] = rnd<T>(v); });
    __syncthreads();
    for (int hc = 0; hc < HID; hc += HC) {
      gemm<T>(Y, CF, R, C, p + offs[FC1_W] + hc, HID, HC,
              [&](int r, int c, float v) {
                Q[r * C3 + c] = rnd<T>(gelu_exact(v + ld(fc1_b + hc + c)));
              });
      __syncthreads();
      gemm<T>(Q, C3, R, HC, p + offs[FC2_W] + hc * C, C, C,
              [&](int r, int c, float v) {
                X[r * C + c] += v + (hc == 0 ? ld(fc2_b + c) : 0.0f);
              });
      __syncthreads();
    }
  }

  T* xo = out + (size_t)s0 * J * C;
  for (int i = tid; i < R * C; i += NT) xo[i] = Num<T>::from_float(X[i]);
}

template <typename T>
int launch(const void* x, const void* bias, const void* masks,
           const void* weights, const void* offs, long long wstride, int nblk,
           void* out, int B, int J, int G, int smem_bytes,
           cudaStream_t stream) {
  auto kern = gat_trunk_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + G - 1) / G;
  kern<<<grid, NT, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(bias),
      static_cast<const float*>(masks), static_cast<const T*>(weights),
      static_cast<const int*>(offs), wstride, nblk, static_cast<T*>(out), B,
      J, G);
  return (int)cudaGetLastError();
}

}  // namespace trunk
}  // namespace gator

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int gat_trunk_launch(int dtype, const void* x, const void* bias,
                                const void* masks, const void* weights,
                                const void* offs, long long wstride, int nblk,
                                void* out, int B, int J, int G, int smem_bytes,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::trunk::launch<float>(x, bias, masks, weights, offs, wstride,
                                       nblk, out, B, J, G, smem_bytes, s);
  return gator::trunk::launch<__nv_bfloat16>(x, bias, masks, weights, offs,
                                             wstride, nblk, out, B, J, G,
                                             smem_bytes, s);
}
