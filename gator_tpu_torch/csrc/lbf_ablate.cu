// T1: the LBF layer with pieces removed or changed, in 13 modes, for the
// timing ablations of gator_tpu_torch/tools/exp_mdr_ablate.py.
//
// Replaces tools/exp_mdr_ablate.py:199 `run_layers` (kernel body
// `_kernel:49`). The device code is lbf_layer.cuh's under T1's rounding
// policy (products and bias adds in f32, operands rounded where they enter
// a product, y3 f32 for the residual), with the mode a template parameter:
// each mode is its own pair of kernels, so no inner loop branches on it.
// The modes that change only the row-local part share the self-attention
// kernel of `full`; lnonly, mlponly and noself have none. What bounds the
// kernels on the H100 is written in lbf_layer.cuh.
#include "lbf_layer.cuh"

namespace gator {
namespace lbf_layer {

template <typename T>
int rows_of_mode(int mode, const void* x, const void* joints,
                 const void* weights, const void* offs, void* y3, void* q2,
                 void* k2, void* v, void* out, int B, int Nv, int J,
                 cudaStream_t s) {
#define GATOR_ROWS(M)                                                        \
  return launch_rows<T, false, M>(x, joints, weights, offs, y3, q2, k2, v, \
                                  out, B, Nv, J, s)
  switch (mode) {
    case FULL:
    case BF16SMAX:
    case NOSOFTMAX: GATOR_ROWS(FULL);
    case LNONLY: GATOR_ROWS(LNONLY);
    case MLPONLY: GATOR_ROWS(MLPONLY);
    case NOCROSS: GATOR_ROWS(NOCROSS);
    case NOMLP: GATOR_ROWS(NOMLP);
    case NOGELU: GATOR_ROWS(NOGELU);
    case TANHGELU: GATOR_ROWS(TANHGELU);
    case BF16GELU: GATOR_ROWS(BF16GELU);
    case NOSELF: GATOR_ROWS(NOSELF);
    case PREPROJ: GATOR_ROWS(PREPROJ);
    case FOLD1DOT: GATOR_ROWS(FOLD1DOT);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GATOR_ROWS
}

template <typename T>
int attn_of_mode(int mode, const void* q2, const void* k2, const void* v,
                 const void* y3, const void* weights, const void* offs,
                 void* out, int B, int Nv, cudaStream_t s) {
#define GATOR_ATTN(M) \
  return launch_attn<T, false, M>(q2, k2, v, y3, weights, offs, out, B, Nv, s)
  switch (mode) {
    case FULL:
    case NOCROSS:
    case NOMLP:
    case NOGELU:
    case TANHGELU:
    case BF16GELU: GATOR_ATTN(FULL);
    case PREPROJ: GATOR_ATTN(PREPROJ);
    case FOLD1DOT: GATOR_ATTN(FOLD1DOT);
    case BF16SMAX: GATOR_ATTN(BF16SMAX);
    case NOSOFTMAX: GATOR_ATTN(NOSOFTMAX);
    default: return (int)cudaErrorInvalidValue;  // a row-local mode
  }
#undef GATOR_ATTN
}

}  // namespace lbf_layer
}  // namespace gator

// dtype: 0 = float32, 1 = bfloat16; mode: the index in `enum Mode`. Each
// returns the cudaError_t of its launch. x, joints, q2, k2, v and out are
// T; y3 is f32 [B, Nv, 64]; v is [B, Nv, 128] for fold1dot, else
// [B, Nv, 64]. The row-local modes (lnonly, mlponly, noself) write out in
// the rows launch and have no attention launch.
extern "C" int lbf_ablate_rows_launch(int dtype, int mode, const void* x,
                                      const void* joints,
                                      const void* weights, const void* offs,
                                      void* y3, void* q2, void* k2, void* v,
                                      void* out, int B, int Nv, int J,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::lbf_layer::rows_of_mode<float>(
        mode, x, joints, weights, offs, y3, q2, k2, v, out, B, Nv, J, s);
  return gator::lbf_layer::rows_of_mode<__nv_bfloat16>(
      mode, x, joints, weights, offs, y3, q2, k2, v, out, B, Nv, J, s);
}

extern "C" int lbf_ablate_attn_launch(int dtype, int mode, const void* q2,
                                      const void* k2, const void* v,
                                      const void* y3, const void* weights,
                                      const void* offs, void* out, int B,
                                      int Nv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gator::lbf_layer::attn_of_mode<float>(mode, q2, k2, v, y3, weights,
                                                 offs, out, B, Nv, s);
  return gator::lbf_layer::attn_of_mode<__nv_bfloat16>(
      mode, q2, k2, v, y3, weights, offs, out, B, Nv, s);
}
